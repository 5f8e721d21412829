"""TF1 checkpoints in the port without tensorflow (``core/tf1_format.py``,
``tf1_import.py``, ``tf1_export.py``, the ``.ckpt`` warm start and ``tools
export-tf1``), with TensorFlow as the witness that writes and reads the
files, and the JAX package's importer and exporter as the reference.

Every comparison is exact: tensors bit for bit (bf16 as its bit pattern,
widened to f32 exactly), trees leaf for leaf, and the port's files entry for
entry with what TF's own ``Saver`` writes.
"""

import os

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import torch  # noqa: E402
from tensorflow.python.training import py_checkpoint_reader  # noqa: E402

from acoustic_image_generation_tpu.core import tf1_export as jexport  # noqa: E402
from acoustic_image_generation_tpu.core import tf1_import as jimport  # noqa: E402
from acoustic_image_generation_tpu.train import warmstart as jwarm  # noqa: E402
from acoustic_image_generation_tpu.train.state import TrainState as JaxState  # noqa: E402
from acoustic_image_generation_tpu_torch import bridge  # noqa: E402
from acoustic_image_generation_tpu_torch.cli import tools  # noqa: E402
from acoustic_image_generation_tpu_torch.core import tf1_export, tf1_format, tf1_import  # noqa: E402
from acoustic_image_generation_tpu_torch.data.tfrecord import masked_crc32c  # noqa: E402
from acoustic_image_generation_tpu_torch.train import checkpoint, warmstart  # noqa: E402
from acoustic_image_generation_tpu_torch.train.embed import EmbedConfig, EmbedTask  # noqa: E402
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask  # noqa: E402
from acoustic_image_generation_tpu_torch.train.trainer import Trainer  # noqa: E402

tf1 = tf.compat.v1


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads, beside the other test workers (full-width tasks
    on the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _values(rng):
    return {
        "net/f32": rng.normal(size=(3, 4)).astype(np.float32),
        "net/f64": rng.normal(size=(5,)),
        "net/i32": rng.integers(-9, 9, (2, 3)).astype(np.int32),
        "net/i64": np.asarray(7, np.int64),
        "net/bool": np.array([True, False, True]),
        "net/f16": rng.normal(size=(4,)).astype(np.float16),
        "net/bf16": rng.normal(size=(6,)).astype(np.float32),  # saved as bfloat16
        "net/empty": np.zeros((0, 3), np.float32),
    }


def tf_save(path, values, *, version=tf1.train.SaverDef.V2, shards=1):
    """``values`` written by TF's own Saver; ``shards`` > 1: the variables
    spread over that many CPU devices and a sharded save (one data file
    each)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with tf.Graph().as_default():
        tf_vars = {}
        for i, (name, value) in enumerate(values.items()):
            with tf.device(f"/cpu:{i % shards}"):
                dtype = tf.bfloat16 if name.endswith("bf16") else None
                tf_vars[name] = tf1.get_variable(name, initializer=tf1.constant(value, dtype=dtype))
        saver = tf1.train.Saver(var_list=tf_vars, write_version=version, sharded=shards > 1)
        with tf1.Session(config=tf1.ConfigProto(device_count={"CPU": shards})) as sess:
            sess.run(tf1.global_variables_initializer())
            return saver.save(sess, path, write_meta_graph=False)


def tf_read(path):
    """TF's reader: every tensor it can read (bf16 as its bit pattern)."""
    reader = py_checkpoint_reader.NewCheckpointReader(path)
    out = {}
    for name in reader.get_variable_to_shape_map():
        try:
            value = np.asarray(reader.get_tensor(name))
        except Exception:  # TF's V1 reader has no f16
            continue
        out[name] = value.view(np.uint16) if str(value.dtype) == "bfloat16" else value
    return out


def assert_bits(got: dict, want: dict):
    assert set(got) == set(want), set(got) ^ set(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), name


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """TF-written files: V2, V1 (no bf16: TF's V1 writer refuses it) and a
    V2 checkpoint in two shards."""
    root = tmp_path_factory.mktemp("tf1")
    values = _values(np.random.default_rng(0))
    v1 = {k: v for k, v in values.items() if not k.endswith("bf16")}
    paths = {
        "v2": tf_save(str(root / "v2" / "m.ckpt"), values),
        "v1": tf_save(str(root / "v1" / "m.ckpt"), v1, version=tf1.train.SaverDef.V1),
        "sharded": tf_save(str(root / "sh" / "m.ckpt"), values, shards=2),
    }
    return paths, values


@pytest.mark.parametrize("kind", ["v2", "v1", "sharded"])
def test_reads_tf_written_files_bit_for_bit(written, kind):
    paths, values = written
    got = tf1_format.read_checkpoint(paths[kind])
    want = tf_read(paths[kind])
    if kind == "sharded":
        assert os.path.exists(paths[kind] + ".data-00001-of-00002")
    if kind == "v1":  # TF cannot read its own V1 f16 back: held to the values saved
        assert "net/f16" not in want
        want["net/f16"] = values["net/f16"]
    assert_bits(got, want)
    for name, value in values.items():
        if name.endswith("bf16"):
            if kind != "v1":
                widened = tf1_import.load_tf1_checkpoint(paths[kind])[name]
                assert widened.dtype == np.float32
                np.testing.assert_array_equal(widened, tf.constant(value, tf.bfloat16).numpy().astype(np.float32))
        else:
            assert got[name].tobytes() == np.asarray(value).tobytes(), name


def test_tf_reads_port_files_bit_for_bit(tmp_path):
    """What the port writes, TF's reader reads bit for bit, every tensor
    looked up through the index: more than one 256 KiB block in the index
    (each keyed by its block's last key). The tensor entries and the data
    shard are those TF's own Saver writes for the same tensors, and so is
    the ``checkpoint`` state file."""
    rng = np.random.default_rng(1)
    values = {k: v for k, v in _values(rng).items() if not k.endswith("bf16")}
    for i in range(400):  # long names that share little, so that the index outgrows one block
        name = f"{i:04d}/" + bytes(rng.integers(97, 123, 700).astype(np.uint8)).decode()
        values[name] = rng.normal(size=(2, i % 3)).astype(np.float32)
    os.makedirs(tmp_path / "port")
    path = tf1_format.write_checkpoint(str(tmp_path / "port" / "m.ckpt"), values)
    assert_bits(tf_read(path), values)
    assert os.path.getsize(path + ".index") > tf1_format.BLOCK_BYTES
    theirs = tf_save(str(tmp_path / "tf" / "m.ckpt"), values)
    assert tf1_format.read_table(path + ".index") == tf1_format.read_table(theirs + ".index")
    suffix = ".data-00000-of-00001"
    assert open(path + suffix, "rb").read() == open(theirs + suffix, "rb").read()
    state = (tmp_path / "port" / "checkpoint").read_text()
    assert state == (tmp_path / "tf" / "checkpoint").read_text().replace(theirs, path)
    assert tf.train.latest_checkpoint(str(tmp_path / "port")).endswith("m.ckpt")
    assert_bits(tf1_format.read_checkpoint(path), values)


def test_corruption_and_compression_raise_by_name(tmp_path):
    values = {"a/w": np.arange(64, dtype=np.float32), "b/w": np.ones(3, np.float32)}
    path = tf1_format.write_checkpoint(str(tmp_path / "m.ckpt"), values)
    data = path + ".data-00000-of-00001"
    raw = bytearray(open(data, "rb").read())
    raw[5] ^= 1
    open(data, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="crc32c mismatch in tensor 'a/w'"):
        tf1_format.read_checkpoint(path)
    # a snappy block: the index's data block with its type byte 1 and a
    # trailer crc that matches, so only the compression is wrong
    index = bytearray(open(path + ".index", "rb").read())
    footer = bytes(index[-tf1_format.FOOTER_BYTES:])
    _, _, pos = tf1_format._handle(footer)
    offset, size, _ = tf1_format._handle(footer, pos)  # the index block
    inner_offset, inner_size, _ = tf1_format._handle(next(tf1_format._entries(bytes(index[offset:offset + size])))[1])
    index[inner_offset + inner_size] = 1
    index[inner_offset + inner_size + 1:inner_offset + inner_size + 5] = masked_crc32c(
        bytes(index[inner_offset:inner_offset + inner_size + 1])).to_bytes(4, "little")
    open(path + ".index", "wb").write(bytes(index))
    with pytest.raises(IOError, match="snappy-compressed block"):
        tf1_format.read_checkpoint(path)
    index[inner_offset + 3] ^= 4  # and a flipped byte inside a block
    open(path + ".index", "wb").write(bytes(index))
    with pytest.raises(IOError, match="block checksum mismatch"):
        tf1_format.read_checkpoint(path)
    with pytest.raises(ValueError, match="uint8"):
        tf1_format.write_checkpoint(str(tmp_path / "u.ckpt"), {"x": np.zeros(2, np.uint8)})
    with pytest.raises(ValueError, match="'x/u8': dtype uint8 is not one of"):
        tf1_format.read_checkpoint(tf_save(str(tmp_path / "tf" / "u.ckpt"), {"x/u8": np.ones(3, np.uint8)}))


# ------------------------------------------------------------ the name conventions, against JAX


def _trees(rng):
    """One tree per naming convention (as ``tests/test_tf1_import.py``):
    tf.layers with BN, deconv, dense, VAE head and the unnamed decoder conv;
    slim ResNet with a fixed-pad root conv and a ``conv``-wrapped unit conv;
    VGGish repeat scopes; DualCamNet's slim dense."""
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    unet = ({"layer1": {"conv_1": {"kernel": f32(3, 3, 12, 16), "bias": f32(16)},
                        "bn_1": {"scale": f32(16), "bias": f32(16)}},
             "upsample_1": {"kernel": f32(2, 2, 32, 16)},
             "dense": {"kernel": f32(15, 24), "bias": f32(24)},
             "vae": {"mean": {"kernel": f32(3, 4, 13, 15), "bias": f32(15)}},
             "conv_dec": {"kernel": f32(3, 3, 15, 13), "bias": f32(13)}},
            {"layer1": {"bn_1": {"mean": f32(16), "var": np.abs(f32(16))}}})
    resnet = ({"conv1": {"kernel": f32(7, 7, 3, 8), "BatchNorm": {"scale": f32(8), "bias": f32(8)}},
               "block2_unit_4": {"conv1": {"conv": {"kernel": f32(1, 1, 16, 8)},
                                           "BatchNorm": {"scale": f32(8), "bias": f32(8)}}}},
              {"conv1": {"BatchNorm": {"mean": f32(8), "var": np.abs(f32(8))}}})
    vggish = ({"conv3_1": {"kernel": f32(3, 3, 4, 6), "bias": f32(6)}}, None)
    dualcam = ({"full1": {"kernel": f32(12, 10), "bias": f32(10)}}, None)
    return {("UNetAcRes", False): unet, ("resnet_v1_50", True): resnet, ("vggish", True): vggish,
            ("DualCamNet", True): dualcam}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def assert_trees_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys(), set(got) ^ set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, w), k


def test_export_scope_and_import_scope_match_jax(tmp_path):
    tensors, jax_tensors = {}, {}
    trees = _trees(np.random.default_rng(2))
    for (scope, slim), (params, stats) in trees.items():
        variables = {"params": params, "batch_stats": stats}
        tensors.update(tf1_export.export_scope(variables, scope, slim=slim))
        jax_tensors.update(jexport.export_scope(variables, scope, slim=slim))
    assert_bits(tensors, {k: np.asarray(v) for k, v in jax_tensors.items()})
    # the port's file through TF's reader (JAX's importer), JAX's file (TF's
    # Saver) through the port's reader
    ours = tf1_export.save_tf1_checkpoint(str(tmp_path / "port.ckpt"), tensors, global_step=5)
    theirs = jexport.save_tf1_checkpoint(str(tmp_path / "jax.ckpt"), jax_tensors, global_step=5)
    want = jimport.load_tf1_checkpoint(ours)
    assert_bits(tf1_import.load_tf1_checkpoint(theirs), want)
    assert_bits(tf1_import.load_tf1_checkpoint(ours), want)
    assert int(want["global_step"]) == 5 and want["global_step"].dtype == np.int64
    for scope, slim in trees:
        p, s = tf1_import.import_scope(want, scope)
        jp, js = jimport.import_scope(want, scope)
        assert_trees_equal(p, jp)
        assert_trees_equal(s, js)


def test_merge_into_matches_jax_strict_and_not():
    rng = np.random.default_rng(3)
    trees = _trees(rng)
    tensors = {}
    for (scope, slim), (params, stats) in trees.items():
        tensors.update(tf1_export.export_scope({"params": params, "batch_stats": stats}, scope, slim=slim))
    tensors["UNetAcRes/layer1/conv_1/kernel/Adam"] = np.zeros((3, 3, 12, 16), np.float32)  # skipped
    tensors["UNetAcRes/extra/kernel"] = np.zeros(2, np.float32)  # no template node
    for (scope, _), (params, stats) in trees.items():
        p, s = tf1_import.import_scope(tensors, scope)
        zeros = lambda t: {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v) for k, v in t.items()}
        for template, imported in ((params, p), (stats, s)):
            if template is None:
                continue
            got = tf1_import.merge_into(zeros(template), imported)
            assert_trees_equal(got, jimport.merge_into(zeros(template), imported))
            assert_trees_equal(got, template)
            if scope == "UNetAcRes" and template is params:
                for merge in (tf1_import.merge_into, jimport.merge_into):
                    with pytest.raises(KeyError, match="extra"):
                        merge(zeros(template), imported, strict=True)
            else:
                assert_trees_equal(tf1_import.merge_into(zeros(template), imported, strict=True), template)
    bad = {"full1": {"kernel": np.zeros((6, 10), np.float32)}}
    for merge in (tf1_import.merge_into, jimport.merge_into):
        with pytest.raises(ValueError, match="shape mismatch at full1/kernel"):
            merge(bad, tf1_import.import_scope(tensors, "DualCamNet")[0])


# ------------------------------------------------------------ warm starts, against JAX


def _source_checkpoint(task_cls, cfg, key, scope, slim, path, extra=None):
    """A TF1 checkpoint (TF's Saver, through JAX's exporter) of model
    ``key`` of another seed's weights, plus ``extra`` tensors."""
    params, stats = bridge.to_flax(task_cls(cfg, device="cpu").init_params(7))
    tensors = jexport.export_scope({"params": params[key], "batch_stats": stats.get(key)}, scope, slim=slim)
    tensors.update(extra or {})
    return jexport.save_tf1_checkpoint(path, tensors, global_step=3), params, stats


@pytest.mark.parametrize("key", ["resnet", "acoustic", "audio"])
def test_ckpt_warm_start_matches_jax(tmp_path, key):
    if key == "resnet":
        task_cls, cfg = GenerationTask, GenerationConfig(resnet_units=(1, 1, 1, 1), compute_dtype="float32")
        extra = {"resnet_v1_50/logits/weights": np.ones((1, 1, 2048, 5), np.float32),
                 "resnet_v1_50/conv_map/weights": np.ones((1, 1, 2048, 3), np.float32)}
        path, src_p, src_s = _source_checkpoint(task_cls, cfg, key, "resnet_v1_50", True,
                                                str(tmp_path / "imagenet.ckpt"), extra)
    else:  # UNetAcoustic (no BN), UNetAudio (tf.layers BN: gamma, beta and the moving statistics)
        task_cls, cfg = EmbedTask, EmbedConfig(compute_dtype="float32")
        path, src_p, src_s = _source_checkpoint(task_cls, cfg, key, tf1_export.SCOPES[key], False,
                                                str(tmp_path / f"{key}.ckpt"))
    task = task_cls(cfg, device="cpu").init_params(0)
    params, stats = bridge.to_flax(task)
    want = jwarm.overlay_model(JaxState(step=0, params=params, batch_stats=stats, opt_state=None), key, path)
    state = Trainer(task).init_state()
    warmstart.overlay_model(state, key, path)
    got_p, got_s = bridge.to_flax(task)
    assert_trees_equal(got_p, want.params)
    assert_trees_equal(got_s, want.batch_stats)
    # the model is the source's, but for the heads the ImageNet start skips
    moved = {k: v for k, v in src_p[key].items() if k != "conv_map"}
    assert_trees_equal({k: got_p[key][k] for k in moved}, moved)
    if key in src_s:
        assert_trees_equal(got_s[key], src_s[key])
    others = [k for k in params if k != key]  # the other models stay as they were
    assert_trees_equal({k: got_p[k] for k in others}, {k: params[k] for k in others})
    if key == "resnet":
        assert_trees_equal(got_p[key]["conv_map"], params[key]["conv_map"])
    # init_checkpoint takes the JAX package's file format only
    with pytest.raises(ValueError, match="TF1 checkpoint"):
        warmstart.restore_params_only(state, path)


def test_import_resnet50_imagenet_reads_v1_as_jax(tmp_path):
    """A V1 file (no ``.index``) reaches the ImageNet import, as in JAX."""
    task = GenerationTask(GenerationConfig(resnet_units=(1, 1, 1, 1), compute_dtype="float32"),
                          device="cpu").init_params(0)
    params, stats = bridge.to_flax(task)
    src = bridge.to_flax(GenerationTask(task.cfg, device="cpu").init_params(5))
    tensors = jexport.export_scope({"params": src[0]["resnet"], "batch_stats": src[1]["resnet"]}, "resnet_v1_50",
                                   slim=True)
    path = tf_save(str(tmp_path / "v1" / "imagenet.ckpt"), tensors, version=tf1.train.SaverDef.V1)
    assert not os.path.exists(path + ".index")
    template = {"params": params["resnet"], "batch_stats": stats["resnet"]}
    got = tf1_import.import_resnet50_imagenet(path, template)
    want = jimport.import_resnet50_imagenet(path, template)
    assert_trees_equal(got["params"], want["params"])
    assert_trees_equal(got["batch_stats"], want["batch_stats"])
    assert_trees_equal(got["params"]["block4_unit_1"], src[0]["resnet"]["block4_unit_1"])
    assert_trees_equal(got["params"]["conv_map"], params["resnet"]["conv_map"])


def test_tools_export_tf1_of_a_cpu_checkpoint(tmp_path, capsys):
    """``tools export-tf1`` of a generation checkpoint: JAX's loader (TF's
    reader) gets JAX's export of the same trees, with the step as
    ``global_step``."""
    flags = ["--embedding", "1", "--mfcc", "1", "--resnet_units", "1,1,1,1", "--compute_dtype", "float32",
             "--device", "cpu", "--seed", "4"]
    from acoustic_image_generation_tpu_torch.cli.main import build_parser, config_from_args, select_task

    config = config_from_args(build_parser().parse_args(flags))
    task = select_task(config, "cpu")
    trainer = Trainer(task, config)
    rng = np.random.default_rng(0)
    raw = dict(acoustic=rng.random((1, 2, 36, 48, 12), dtype=np.float32),
               audio=rng.integers(-3000, 3000, (1, 2, 1024)).astype(np.int32),
               video=rng.integers(0, 256, (1, 2, 224, 298, 3)).astype(np.uint8))
    state, _ = trainer.train_step(trainer.init_state(), raw, eps=np.zeros((2, 150), np.float32))
    ckpt_path = checkpoint.save_checkpoint(str(tmp_path / "run"), 3, state)
    out = str(tmp_path / "export" / "flagship.ckpt")
    os.makedirs(os.path.dirname(out))
    assert tools.main(["export-tf1", ckpt_path, out, "--", *flags]) == 0
    assert capsys.readouterr().out.strip().endswith(out)
    params, stats = bridge.to_flax(task)
    want_path = jexport.export_generation_checkpoint(params, stats, str(tmp_path / "jax.ckpt"), global_step=1)
    assert_bits(jimport.load_tf1_checkpoint(out), jimport.load_tf1_checkpoint(want_path))
    assert int(tf1_import.load_tf1_checkpoint(out)["global_step"]) == 1
