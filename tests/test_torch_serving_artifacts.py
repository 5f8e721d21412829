"""The port's serving artifacts (``core/serving.py``) against the JAX
package, in f32 on the CPU: each kind exported by the port, loaded and
served, against JAX's in-process function on the same weights (the trees
the artifact holds, handed to JAX) with JAX's noise draws handed in; the
weight digest against JAX's ``_params_digest`` (the generation, int8,
classification and embedding kinds: the projection and joint kinds hash
their trees with the same function); the manifest's keys against
one JAX ``export_generation`` at a tiny width; the int8 artifact against
the in-process int8 service; the fixed and polymorphic batch; the
rejections.

Weights are the port's random initial ones with the biases, BN parameters
and running statistics drawn away from their initial values. Widths: the
trunk 1/1/1/1 (the generator, DualCamNet and the VAEs have fixed widths).

Tolerances, as the in-process tests state them: the generation output 1e-4
absolute and its energy map 1e-3 relative (``test_torch_serving.py``); the
clip logits 1e-6 (``test_torch_dualcamnet.py``); the latents and the
projected and joint images within 1e-5 of the largest entry
(``test_torch_embed.py``, ``test_torch_project.py``,
``test_torch_joint.py``). The artifact against the in-process port
service on the same weights: equal to the bit (the same modules run).
"""

import json
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.core import serving as jserving
from acoustic_image_generation_tpu.core.config import DataConfig, ExperimentConfig, ModelConfig, ParallelConfig
from acoustic_image_generation_tpu.data.preprocess import Batch as JaxBatch
from acoustic_image_generation_tpu.dsp.energy import find_logen as jax_find_logen
from acoustic_image_generation_tpu.train.classify import ClassificationTask as JaxClassify
from acoustic_image_generation_tpu.train.embed import EmbedTask as JaxEmbed
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxGeneration
from acoustic_image_generation_tpu.train.joint import JointTask as JaxJoint
from acoustic_image_generation_tpu.train.project import ProjectTask as JaxProject
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core import serving
from acoustic_image_generation_tpu_torch.models.layers import init_modules
from acoustic_image_generation_tpu_torch.serving import GenerationService
from acoustic_image_generation_tpu_torch.train.classify import ClassificationTask, ClassifyConfig
from acoustic_image_generation_tpu_torch.train.embed import EmbedConfig, EmbedTask
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from acoustic_image_generation_tpu_torch.train.joint import JointConfig, JointTask
from acoustic_image_generation_tpu_torch.train.project import ProjectConfig, ProjectTask
from task_parity import rel, with_normals
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir, tmp_path  # noqa: F401

UNITS = (1, 1, 1, 1)
# the keys a port manifest adds to JAX's, or fills in its own way
FORMAT_KEYS = {"format", "platforms", "module_bytes", "module_sha256", "external_weights", "weights_bytes",
               "external_weights_sha256", "model"}


def jax_cfg(**model):
    return ExperimentConfig(data=DataConfig(sample_length=1), model=ModelConfig(**model),
                            parallel=ParallelConfig(compute_dtype="float32"))


def perturbed(task, seed):
    """``task`` (initialized) with every 1-D tensor (biases, BN scales and
    shifts, running statistics) drawn away from its initial value."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, t in (*task.named_parameters(), *task.named_buffers()):
            if t.dim() != 1 or not t.is_floating_point():
                continue
            if bool((t > 0).all()):  # BN scales and variances
                t.mul_(0.75 + 0.5 * torch.rand(t.shape, generator=g))
            else:
                t.add_(0.1 * torch.randn(t.shape, generator=g))
    return task


def frames(seed, n, channels=12):
    rng = np.random.default_rng(seed)
    return dict(
        mfcc=rng.random((n, 12), dtype=np.float32),
        video=rng.random((n, 224, 298, 3), dtype=np.float32),
        acoustic=rng.random((n, 36, 48, channels), dtype=np.float32),
        audio=rng.integers(-2**15, 2**15, (n, 1024)).astype(np.float32),
    )


def jax_batch(x):
    n = x["audio"].shape[0]
    zeros = jnp.zeros((n,), jnp.int32)
    return JaxBatch(acoustic=jnp.asarray(x["acoustic"]), audio=jnp.asarray(x["audio"]), mfcc=jnp.asarray(x["mfcc"]),
                    video=jnp.asarray(x["video"]), action=zeros, location=zeros,
                    filtered_mfcc=jnp.zeros((n, 12)))


def exported(task, tmp_path, export, **kw):
    """``task`` through ``export`` into ``tmp_path``, loaded on the CPU, with
    its trees in JAX's layout."""
    manifest = export(task, str(tmp_path), **kw)
    params, stats = bridge.to_flax(task)
    return manifest, serving.load_artifact(str(tmp_path), device="cpu"), params, stats


@pytest.fixture(scope="module")
def generation(tmp_path_factory):
    """The tiny generator exported with its energy map, loaded, and the one
    JAX export of the same weights (external weights, for the CPU)."""
    task = perturbed(GenerationTask(GenerationConfig(resnet_units=UNITS, compute_dtype="float32"),
                                    device="cpu").init_params(0), 1)
    with module_dir(tmp_path_factory, "gen") as tmp:
        path = tmp / "port"
        manifest, model, params, stats = exported(task, path, serving.export_generation, energy=True)
        jtask = JaxGeneration(jax_cfg(resnet_units=UNITS))
        jax_manifest = jserving.export_generation(jtask, types.SimpleNamespace(params=params, batch_stats=stats),
                                                  str(tmp / "jax"), energy=True, platforms=("cpu",),
                                                  external_weights=True)
        yield types.SimpleNamespace(task=task, path=path, manifest=manifest, model=model, params=params,
                                    stats=stats, jtask=jtask, jax_manifest=jax_manifest)


def test_generation_matches_jax(generation):
    g = generation
    x = frames(0, 3)
    (want, want_energy), draws = with_normals(
        lambda p, s, m, v: (lambda out: (out, jax_find_logen(out)))(
            g.jtask.generate(p, s, m, v, jax.random.key(5))))(g.params, g.stats, jnp.asarray(x["mfcc"]),
                                                                jnp.asarray(x["video"]))
    assert len(draws) == 1 and draws[0].shape == (3, 150)
    gen, energy = g.model.generate(x["mfcc"], x["video"], eps=np.asarray(draws[0]))
    assert gen.shape == (3, 36, 48, 12) and gen.dtype == np.float32 and energy.shape == (3, 36, 48)
    np.testing.assert_allclose(gen, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(energy, want_energy, rtol=1e-3, atol=0)
    # the in-process service on the exported task, and the batch is polymorphic
    for n in (3, 1):
        want_gen, want_en = GenerationService(g.task).generate(x["mfcc"][:n], x["video"][:n], seed=9)
        gen, energy = g.model.generate(x["mfcc"][:n], x["video"][:n], seed=9)
        np.testing.assert_array_equal(gen, want_gen.numpy())
        np.testing.assert_array_equal(energy, want_en.numpy())


def test_generation_digest_and_manifest_match_jax(generation):
    g = generation
    assert g.manifest["weights_sha256"] == jserving._params_digest(g.params, g.stats, None)
    assert g.manifest["format"] == "aig-serving-torch-v1" and g.manifest["platforms"] == ["cuda", "cpu"]
    assert g.manifest["external_weights"] is True
    shared = set(g.jax_manifest) - FORMAT_KEYS
    assert shared == set(g.manifest) - FORMAT_KEYS
    assert {k: g.manifest[k] for k in shared} == {k: g.jax_manifest[k] for k in shared}
    # flax reads the port's weights file: JAX's trees, and JAX's digest of them
    import flax.serialization

    restored = flax.serialization.msgpack_restore((g.path / serving.WEIGHTS).read_bytes())
    assert restored.keys() == {"params", "batch_stats"}
    assert jserving._params_digest(restored["params"], restored["batch_stats"]) == g.manifest["weights_sha256"]


def test_int8_artifact_serves_the_unfused_trunk_at_a_fixed_batch(tmp_path):
    cfg = GenerationConfig(resnet_units=UNITS, compute_dtype="float32", trunk_bn="frozen", trunk_quant="int8")
    task = perturbed(GenerationTask(cfg, device="cpu").init_params(2), 3)
    x = frames(1, 2)
    qtrunk = task.build_qtrunk(torch.from_numpy(x["video"]))
    manifest, model, params, stats = exported(task, tmp_path, serving.export_generation, qtrunk=qtrunk, batch=2)
    assert manifest["trunk_quant"] == "int8" and manifest["batch"] == 2 and manifest["outputs"] == ["generated"]
    assert manifest["weights_sha256"] == jserving._params_digest(params, stats, bridge.qtrunk_to_tree(qtrunk))
    eps = np.random.default_rng(4).standard_normal((2, 150)).astype(np.float32)
    want, _ = GenerationService(task, qtrunk).generate(x["mfcc"], x["video"], eps=eps)
    got = model.generate(x["mfcc"], x["video"], eps=eps)
    np.testing.assert_array_equal(got, want.numpy())
    with pytest.raises(ValueError, match="fixed batch 2"):
        model.generate(x["mfcc"][:1], x["video"][:1])


@pytest.mark.parametrize("mfccmap", [False, True], ids=["acoustic", "mfccmap"])
def test_classification_matches_jax(mfccmap, tmp_path):
    task = perturbed(ClassificationTask(ClassifyConfig(compute_dtype="float32", mfccmap=mfccmap), device="cpu")
                     .init_params(5), 6)
    manifest, model, params, stats = exported(task, tmp_path, serving.export_classification)
    assert manifest["weights_sha256"] == jserving._params_digest(params)
    assert manifest["num_frames"] == 12 and manifest["inputs"] == (
        {"mfcc": ["b*F", 12]} if mfccmap else {"acoustic": ["b*F", 36, 48, 12]})
    x = frames(2, 24)
    jtask = JaxClassify(jax_cfg(mfccmap=mfccmap))
    want = np.asarray(jax.jit(jtask._logits)(params, jax_batch(x)))
    got = model.classify(x["mfcc"] if mfccmap else x["acoustic"])
    assert got.shape == (2, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="whole clips of 12 frames, got 13"):
        model.classify((x["mfcc"] if mfccmap else x["acoustic"])[:13])


def test_embedding_matches_jax(tmp_path):
    task = perturbed(EmbedTask(EmbedConfig(compute_dtype="float32"), device="cpu").init_params(7), 8)
    manifest, model, params, stats = exported(task, tmp_path, serving.export_embedding)
    assert manifest["weights_sha256"] == jserving._params_digest(params, stats)
    assert manifest["latent_dim"] == 128 and manifest["use_mean"] is False
    x = frames(3, 24)
    jtask = JaxEmbed(jax_cfg(embedding=True))
    (sampled, means), draws = with_normals(lambda p, s, b: [jtask.embeddings(p, s, b, jax.random.key(11), use_mean=m)
                                                            for m in (False, True)])(params, stats, jax_batch(x))
    for use_mean, want in ((False, sampled), (True, means)):
        model.manifest["use_mean"] = use_mean  # the served function's one switch
        got = model.embed(x["acoustic"], x["audio"], x["video"], eps=None if use_mean else np.asarray(draws[0]))
        for name in ("acoustic", "audio", "video"):
            assert got[name].shape == (2, 128)
            assert rel(got[name], want[name]) <= 1e-5, (name, use_mean)
    with pytest.raises(ValueError, match="whole seconds of 12 frames, got 13"):
        model.embed(x["acoustic"][:13], x["audio"][:13], x["video"][:13])


@pytest.fixture(scope="module")
def vaes():
    """One set of the three VAEs' weights, for the projection and the joint
    task (the same latent sizes)."""
    task = perturbed(ProjectTask(ProjectConfig(fusion=True, compute_dtype="float32"), device="cpu").init_params(9), 10)
    return task


def test_projection_matches_jax(vaes, tmp_path):
    manifest, model, params, stats = exported(vaes, tmp_path, serving.export_projection)
    assert (manifest["kind"], manifest["encoder_type"], manifest["fusion"]) == ("projection", "Video", True)
    x = frames(4, 24)
    jtask = JaxProject(jax_cfg(embedding=True, project=True, fusion=True))
    want, draws = with_normals(
        lambda p, s, b: jtask._forward(p, s, b, {"latent": jax.random.key(12)}, train=False)[1].output)(
        params, stats, jax_batch(dict(x, acoustic=np.zeros_like(x["acoustic"]))))
    assert draws[-1].shape == (2, 150)
    got = model.project(x["audio"], x["video"], eps=np.asarray(draws[-1]))
    assert got.shape == (2, 36, 48, 12) and rel(got, want) <= 1e-5
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_joint_matches_jax(vaes, tmp_path):
    task = JointTask(JointConfig(onlyaudiovideo=True, compute_dtype="float32"), device="cpu")
    with torch.no_grad():
        for name in ("acoustic", "audio", "video"):
            getattr(task, name).load_state_dict(getattr(vaes, name).state_dict())
    for i, name in enumerate(("associator", "associator1")):
        init_modules(getattr(task, name), 13 + i)
    perturbed(task.associator1, 15)
    manifest, model, params, stats = exported(task, tmp_path, serving.export_joint)
    assert (manifest["kind"], manifest["variant"]) == ("joint", "onlyaudiovideo")
    x = frames(5, 24)
    jtask = JaxJoint(jax_cfg(embedding=True, jointmvae=True, onlyaudiovideo=True))

    def serve(p, s, b):  # JAX's export_joint serve
        rngs = {"latent": jax.random.key(15)}
        _, f_vi, f_au = jtask._features(p, s, jtask._inputs(b), rngs, train=False)
        pred = jtask.associator1.apply({"params": p["associator1"]}, f_vi, f_au)
        return jtask._stage2(p, s, "acoustic", pred["ac"], rngs).output

    want, draws = with_normals(serve)(params, stats, jax_batch(dict(x, acoustic=np.zeros_like(x["acoustic"]))))
    assert draws[-1].shape == (2, 150)
    got = model.project(x["audio"], x["video"], eps=np.asarray(draws[-1]))
    assert got.shape == (2, 36, 48, 12) and rel(got, want) <= 1e-5
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def small_artifact(tmp_path_factory):
    task = ClassificationTask(ClassifyConfig(compute_dtype="float32"), device="cpu").init_params(0)
    with module_dir(tmp_path_factory, "cls") as path:
        serving.export_classification(task, str(path))
        yield path


def _edited(src, dst, **changes):
    shutil.copytree(src, dst)
    manifest = json.loads((dst / "manifest.json").read_text())
    manifest.update(changes)
    (dst / "manifest.json").write_text(json.dumps(manifest))
    return str(dst)


@pytest.mark.parametrize("case", ["unknown_format", "jax_artifact", "digest", "size", "platform", "kind_method"])
def test_load_rejects(case, small_artifact, tmp_path):
    dst = tmp_path / "a"
    if case == "unknown_format":
        with pytest.raises(ValueError, match="unsupported serving artifact format 'aig-serving-v9'"):
            serving.load_artifact(_edited(small_artifact, dst, format="aig-serving-v9"), device="cpu")
    elif case == "jax_artifact":
        with pytest.raises(ValueError, match="StableHLO program"):
            serving.load_artifact(_edited(small_artifact, dst, format="aig-serving-v1"), device="cpu")
    elif case == "digest":
        with pytest.raises(ValueError, match="digest mismatch"):
            serving.load_artifact(_edited(small_artifact, dst, external_weights_sha256="0" * 64), device="cpu")
    elif case == "size":  # a truncated weights file: its digest no longer matches
        path = _edited(small_artifact, dst)
        weights = dst / serving.WEIGHTS
        weights.write_bytes(weights.read_bytes()[:-1])
        with pytest.raises(ValueError, match="do not belong to the same export"):
            serving.load_artifact(path, device="cpu")
    elif case == "platform":
        with pytest.raises(RuntimeError, match="runtime is 'cpu'"):
            serving.load_artifact(_edited(small_artifact, dst, platforms=["cuda"]), device="cpu")
    else:
        model = serving.load_artifact(str(small_artifact), device="cpu")
        x = frames(6, 12)
        for call in (lambda: model.generate(x["mfcc"], x["video"]), lambda: model.project(x["audio"], x["video"]),
                     lambda: model.embed(x["acoustic"], x["audio"], x["video"])):
            with pytest.raises(ValueError, match="classification artifact has no"):
                call()


@pytest.mark.parametrize("case", ["fused_qgemm", "energy_13_channels", "spatial_shards", "platform", "plain_joint"])
def test_export_rejects(case, tmp_path):
    out = str(tmp_path / "a")
    if case == "plain_joint":
        with pytest.raises(ValueError, match="onlyaudiovideo or --fusion"):
            serving.export_joint(JointTask(JointConfig(compute_dtype="float32"), device="cpu"), out)
        return
    over = {"fused_qgemm": dict(trunk_bn="frozen", trunk_quant="int8", fused_qgemm=True),
            "energy_13_channels": dict(datatype="music")}.get(case, {})
    task = GenerationTask(GenerationConfig(resnet_units=UNITS, compute_dtype="float32", **over), device="cpu")
    if case == "fused_qgemm":
        with pytest.raises(ValueError, match="fused_qgemm is unsupported"):
            serving.export_generation(task, out, qtrunk=task.build_qtrunk(torch.rand(1, 224, 298, 3)))
    elif case == "energy_13_channels":
        with pytest.raises(ValueError, match="12-channel"):
            serving.export_generation(task, out, energy=True)
    elif case == "spatial_shards":
        with pytest.raises(ValueError, match="external_weights is incompatible with spatial_shards>1"):
            serving.export_generation(task, out, spatial_shards=2, external_weights=True)
    else:
        with pytest.raises(ValueError, match="serves on cuda, cpu"):
            serving.export_generation(task, out, platforms=("tpu", "cpu"))
    assert not (tmp_path / "a").exists()
