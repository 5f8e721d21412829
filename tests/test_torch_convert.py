"""The port's converters (``data/convert.py``, ``data/listing.py`` and the
five ``cli/tools.py`` converter commands) against the JAX package's, on raw
captures that this file writes: 2 classes of 2-second captures (BMP
frames, a 12288 Hz wav, ``video_time.txt``, 128-mic ``.dc`` files) and
small FlickrSoundNet, AVE and collected layouts.

What is held, and how: GZIP shards by their decompressed record streams,
byte for byte (``gzip`` writes the time and the file name into each
header, so the compressed files differ between any two runs); uncompressed
reshards byte for byte; list files line for line with the output roots
mapped; arrays exactly; the tools' printed JSON with the roots mapped.
Without Pillow the image paths raise ``ImportError`` naming it, and audio
alone converts.
"""

import gzip
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from acoustic_image_generation_tpu.cli import tools as jtools
from acoustic_image_generation_tpu.data import convert as jconvert
from acoustic_image_generation_tpu.data import listing as jlisting
from acoustic_image_generation_tpu_torch.cli import tools as ptools
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader
from acoustic_image_generation_tpu_torch.data import convert as pconvert
from acoustic_image_generation_tpu_torch.data import listing as plisting
from acoustic_image_generation_tpu_torch.data import tfrecord
from torch_threads import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECONDS = 2


def _image(path, size, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3), np.uint8)).save(path)


def _wav(path, seconds, fs, seed, dtype=np.int16):
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        data = rng.uniform(-1.2, 1.2, int(seconds * fs)).astype(np.float32)
    else:
        data = rng.integers(-3000, 3000, int(seconds * fs)).astype(dtype)
    wavfile.write(path, fs, data)


def _capture(cap, seed, seconds=SECONDS, video=True):
    (cap / "video").mkdir(parents=True)
    (cap / "audio").mkdir()
    if video:
        for i in range(12 * seconds):
            _image(cap / "video" / f"I_{i + 1:06d}.bmp", (160, 120), seed * 100 + i)
    _wav(cap / "audio" / "output_audio2.wav", seconds, 12288, seed)
    (cap / "video_time.txt").write_text(f"time: {seconds}\n")


def _flickr_xml(path, name, boxes):
    import xml.etree.ElementTree as ET

    root = ET.Element("annotation")
    ET.SubElement(root, "file_name").text = name
    for (x0, y0, x1, y1, kind) in boxes:
        bb = ET.SubElement(ET.SubElement(root, "person"), "bbox")
        for tag, v in (("type", kind), ("xmin", x0), ("ymin", y0), ("xmax", x1), ("ymax", y1)):
            ET.SubElement(bb, tag).text = str(v)
    ET.ElementTree(root).write(path)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Every raw layout the converters read, written once; removed after
    the module."""
    root = tmp_path_factory.mktemp("torch_convert")
    captures = root / "captures"
    for c in range(2):
        _capture(captures / f"class_{c}" / f"data_{c + 3:03d}", seed=c)
    dc = root / "dc" / "audio"
    dc.mkdir(parents=True)
    frames = np.random.default_rng(5).integers(-(2**20), 2**20, (3, 128, 1024)).astype(np.int32)
    for h, frame in enumerate(frames):
        frame.flatten(order="F").tofile(dc / f"A_{h + 1:06d}.dc")

    flickr = root / "flickr"
    data, ann = flickr / "Dataset" / "Data" / "0", flickr / "Dataset" / "Annotations"
    data.mkdir(parents=True)
    ann.mkdir(parents=True)
    for i, fs, dtype in ((3, 22050, np.int16), (7, 44100, np.float32), (9, 8000, np.int16)):
        _image(data / f"{i}.jpg", (256, 256), i)
        _wav(data / f"{i}.wav", 1.5, fs, i, dtype)
        _flickr_xml(ann / f"{i}.xml", f"{i}.jpg", [(10, 20, 120, 200, "object"), (30, 40, 60, 90, "ambient sound")])
    (flickr / "test_list.txt").write_text("3.jpg\n7.jpg\n")  # 9 is not listed

    ave = root / "ave"
    _capture(ave / "class_3" / "data_002", seed=7)
    (ave / "class_3" / "data_002" / "seconds.txt").write_text("1:1\n")

    collected = root / "collected"
    collected.mkdir()
    for i in (14, 20, 21):
        _image(collected / f"{i}.png", (200, 150), i)
        _wav(collected / f"{i}.wav", 0.5, 22050, i)
    (collected / "test_list.txt").write_text("14.png\n20.png\n")
    yield {"root": root, "captures": captures, "dc": root / "dc", "dc_frames": frames, "flickr": flickr,
           "ave": ave, "collected": collected}
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture
def out(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _stream(path) -> bytes:
    """A shard's record stream: decompressed where it is GZIP."""
    with open(path, "rb") as f:
        data = f.read()
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data


def _same_shards(got: list, want: list, got_root, want_root, compressed=True):
    assert [os.path.relpath(p, got_root) for p in got] == [os.path.relpath(p, want_root) for p in want]
    for g, w in zip(got, want):
        assert (tfrecord.detect_compression(g) == "GZIP") is compressed
        assert tfrecord.detect_compression(g) == tfrecord.detect_compression(w)
        assert _stream(g) == _stream(w), g
        if not compressed:
            assert open(g, "rb").read() == open(w, "rb").read(), g


def _lines(path, root=None, to=None) -> list:
    with open(path) as f:
        lines = f.read().splitlines()
    return [line.replace(str(root), str(to)) for line in lines] if root is not None else lines


def _same_lists(got: dict, want: dict, got_root, want_root):
    assert got.keys() == want.keys()
    for k in want:
        assert os.path.relpath(got[k], got_root) == os.path.relpath(want[k], want_root)
        assert _lines(got[k], got_root, want_root) == _lines(want[k])


@pytest.mark.parametrize("modalities,event_window", [((1,), None), ((1, 2), None), ((1,), (1, 1))],
                         ids=["audio", "audio_video", "event"])
def test_convert_capture_dir_matches_jax(raw, out, modalities, event_window):
    cap = str(raw["captures"] / "class_1" / "data_004")
    kw = dict(classes=1, location=4, modalities=modalities, event_window=event_window)
    want = jconvert.convert_capture_dir(cap, str(out / "jax"), **kw)
    got = pconvert.convert_capture_dir(cap, str(out / "port"), **kw)
    assert len(got) == SECONDS
    _same_shards(got, want, out / "port", out / "jax")


def test_write_list_files_and_reshard_match_jax(raw, out):
    """Lists over whole captures, then the training list resharded
    uncompressed: the same files byte for byte, read back by the port's
    loader as the same batches."""
    shards = {}
    for name, mod in (("jax", jconvert), ("port", pconvert)):
        shards[name] = []
        for c in range(2):
            cap = str(raw["captures"] / f"class_{c}" / f"data_{c + 3:03d}")
            shards[name] += mod.convert_capture_dir(cap, str(out / name), classes=c, location=c + 3,
                                                    modalities=(1,))
    lists = {name: mod.write_list_files(str(out / name), shards[name])
             for name, mod in (("jax", jconvert), ("port", pconvert))}
    _same_lists(lists["port"], lists["jax"], out / "port", out / "jax")
    assert len(_lines(lists["port"]["training"])) == SECONDS  # one of two captures, split by capture
    flat = {name: mod.reshard(lists[name]["training"], str(out / f"{name}_flat"))
            for name, mod in (("jax", jconvert), ("port", pconvert))}
    assert _lines(flat["port"], out / "port_flat", out / "jax_flat") == _lines(flat["jax"])
    _same_shards(_lines(flat["port"]), _lines(flat["jax"]), out / "port_flat", out / "jax_flat", compressed=False)
    gz = AcousticImageDataLoader(lists["port"]["training"], "testing", 1, modalities=(1,))
    plain = AcousticImageDataLoader(flat["port"], "testing", 1, modalities=(1,))
    for a, b in zip(gz.batches(0), plain.batches(0)):
        np.testing.assert_array_equal(a.audio, b.audio)


def test_flickr_ave_and_collected_converters_match_jax(raw, out):
    """Audio only; ``test_tools_match_jax`` converts their video too."""
    modalities = (1,)
    for what in ("flickr", "collected"):
        fn = f"convert_{what}"
        want = getattr(jconvert, fn)(str(raw[what]), str(out / "jax" / what), modalities=modalities)
        got = getattr(pconvert, fn)(str(raw[what]), str(out / "port" / what), modalities=modalities)
        assert _lines(got, out / "port", out / "jax") == _lines(want)
        assert len(_lines(got)) == 2  # the unlisted pair is left out
        _same_shards(_lines(got), _lines(want), out / "port", out / "jax")
    want = jconvert.convert_ave(str(raw["ave"]), str(out / "jax" / "ave"), modalities=modalities)
    got = pconvert.convert_ave(str(raw["ave"]), str(out / "port" / "ave"), modalities=modalities)
    assert len(got) == 2
    _same_shards(got, want, out / "port", out / "jax")


def test_dc_frames_and_mic_track_match_jax(raw, out):
    from scipy.io import wavfile

    path = str(raw["dc"] / "audio" / "A_000002.dc")
    got = pconvert.read_dc_frame(path)
    np.testing.assert_array_equal(got, jconvert.read_dc_frame(path))
    np.testing.assert_array_equal(got, raw["dc_frames"][1])
    for mic in (0, 5, 127):
        want = jconvert.mux_mic_wav(str(raw["dc"]), str(out / "jax" / f"{mic}.wav"), mic)
        got = pconvert.mux_mic_wav(str(raw["dc"]), str(out / "port" / f"{mic}.wav"), mic)
        assert open(got, "rb").read() == open(want, "rb").read()
    rate, data = wavfile.read(got)
    assert rate == 12000 and data.dtype == np.float32 and np.abs(data).max() == 1.0


@pytest.mark.parametrize("fs,dtype", [(22050, np.int16), (44100, np.float32), (12288, np.int16),
                                      (12288, np.float32), (8000, np.int32)])
def test_resample_to_12288_matches_jax(fs, dtype):
    rng = np.random.default_rng(fs)
    data = (rng.uniform(-1.3, 1.3, fs // 2) if dtype == np.float32 else rng.integers(-30000, 30000, fs // 2))
    data = data.astype(dtype)
    got = pconvert.resample_to_12288(data, fs)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jconvert.resample_to_12288(data, fs))
    np.testing.assert_array_equal(pconvert._one_second_audio(got), jconvert._one_second_audio(got))


def test_frames_images_and_boxes_match_jax(raw):
    rng = np.random.default_rng(0)
    for shape in ((480, 640, 3), (120, 160, 3), (300, 200, 3)):
        img = rng.integers(0, 255, shape, dtype=np.uint8)
        got = pconvert.prepare_video_frame(img) if shape[1] >= shape[0] else pconvert.aspect_preserving_resize(img)
        want = jconvert.prepare_video_frame(img) if shape[1] >= shape[0] else jconvert.aspect_preserving_resize(img)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pconvert.central_crop(img, 40, 60), jconvert.central_crop(img, 40, 60))
    for path, size in ((raw["collected"] / "14.png", (298, 224)), (raw["collected"] / "20.png", None)):
        np.testing.assert_array_equal(pconvert._read_image(str(path), size=size),
                                      jconvert._read_image(str(path), size=size))
    xml = str(raw["flickr"] / "Dataset" / "Annotations" / "3.xml")
    got, want = pconvert.parse_flickr_xml(xml, "3.jpg"), jconvert.parse_flickr_xml(xml, "3.jpg")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    wav = str(raw["captures"] / "class_0" / "data_003" / "audio" / "output_audio2.wav")
    np.testing.assert_array_equal(pconvert.read_wav(wav), jconvert.read_wav(wav))


def test_make_second_example_matches_jax():
    rng = np.random.default_rng(2)
    kw = dict(
        classes=3, location=7, audio=rng.integers(-1000, 1000, (12, 1024)).astype(np.int32),
        video=rng.integers(0, 255, (12, 224, 298, 3)).astype(np.uint8),
        acoustic=rng.random((12, 36, 48, 12)).astype(np.float32),
        boxes={k: rng.integers(0, 200, (12, 3)).astype(np.int32) for k in ("xmin", "xmax", "ymin", "ymax")},
        classnumber=1, event=4)
    assert pconvert.make_second_example(**kw) == jconvert.make_second_example(**kw)
    assert pconvert.make_second_example(classes=0, location=0) == jconvert.make_second_example(classes=0, location=0)
    assert pconvert.COLLECTED_CLASSNUMBERS == jconvert.COLLECTED_CLASSNUMBERS


def test_listing_tools_match_jax(raw, out):
    """``framecount`` over shards and over raw frames (the wav trimmed),
    ``vggsound_video_list`` and ``ave_capture_layout``: the same files."""
    results = {}
    for name, mod in (("jax", jlisting), ("port", plisting)):
        shards = out / name / "shards"
        for d, n in (("data_000", 3), ("data_001", 2)):
            cap = shards / "class_0" / d
            cap.mkdir(parents=True)
            for i in range(n):
                (cap / f"Data_{i + 1:03d}.tfrecord").write_bytes(b"x")
        frames = out / name / "frames"
        shutil.copytree(raw["captures"], frames)
        _wav(frames / "class_1" / "data_004" / "audio" / "output_audio2.wav", SECONDS + 0.5, 12288, 9)  # trimmed
        csv = out / name / "vgg.csv"
        csv.write_text("url,seconds,class,set\nabc,10,motorboat,test\ndef,5,motorboat,train\n"
                       "ggg,0,waterfall,test\nzzz,0,dog barking,test\n")
        ave = out / name / "ave.csv"
        ave.write_text("Category&VideoID&Quality&StartTime&EndTime\n"
                       + "".join(f"{c}&v{c}{i}&good&{i}&{i + 3}\n" for c in ("Church bell", "Dog") for i in range(10)))
        results[name] = (
            mod.framecount(str(shards), str(out / name / "lists")),
            mod.framecount(str(frames), str(out / name / "lists_raw"), tfrecord=False, trim_wav=True),
            mod.vggsound_video_list(str(csv), str(out / name / "videolista.txt"), split="test"),
            mod.ave_capture_layout(str(ave), str(out / name / "ave_layout")),
        )
    (c_jax, r_jax, v_jax, a_jax), (c_port, r_port, v_port, a_port) = results["jax"], results["port"]
    assert list(c_port.values()) == list(c_jax.values()) == [3, 2]
    assert list(r_port.values()) == list(r_jax.values()) == [SECONDS, SECONDS]
    assert v_port == v_jax and list(a_port.values()) == list(a_jax.values()) and len(a_port) == 16
    jfiles = sorted(p.relative_to(out / "jax") for p in (out / "jax").rglob("*") if p.is_file())
    pfiles = sorted(p.relative_to(out / "port") for p in (out / "port").rglob("*") if p.is_file())
    assert pfiles == jfiles
    for rel in jfiles:
        got, want = (out / "port" / rel).read_bytes(), (out / "jax" / rel).read_bytes()
        assert got.replace(str(out / "port").encode(), str(out / "jax").encode()) == want, rel


def _tool_outputs(mod, argv, capsys) -> str:
    assert mod.main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["convert", "reshard", "convert-flickr", "convert-ave", "convert-collected"])
def test_tools_match_jax(raw, out, cmd, capsys):
    """Each converter command against JAX's: the printed lines with the
    roots mapped, and every file it wrote."""
    source = {"convert": "captures", "reshard": "captures", "convert-flickr": "flickr", "convert-ave": "ave",
              "convert-collected": "collected"}[cmd]
    printed = {}
    for name, mod in (("jax", jtools), ("port", ptools)):
        if cmd == "reshard":
            _tool_outputs(mod, ["convert", str(raw[source]), str(out / name / "gz"), "--modalities", "1"], capsys)
            argv = [cmd, str(out / name / "gz" / "lists" / "training.txt"), str(out / name / "out")]
        else:
            argv = [cmd, str(raw[source]), str(out / name / "out"), "--modalities", "1", "2"]
        printed[name] = _tool_outputs(mod, argv, capsys)
    assert printed["port"].replace(str(out / "port"), str(out / "jax")) == printed["jax"]
    if cmd != "reshard":
        last = json.loads(printed["port"].splitlines()[-1])
        assert set(last) <= {"training", "validation", "testing"} and last
    jfiles = sorted(p.relative_to(out / "jax" / "out") for p in (out / "jax" / "out").rglob("*") if p.is_file())
    pfiles = sorted(p.relative_to(out / "port" / "out") for p in (out / "port" / "out").rglob("*") if p.is_file())
    assert pfiles == jfiles and jfiles
    for rel in jfiles:
        got, want = out / "port" / "out" / rel, out / "jax" / "out" / rel
        if rel.suffix == ".txt":
            assert _lines(got, out / "port", out / "jax") == _lines(want), rel
        else:
            assert _stream(got) == _stream(want), rel
            if cmd == "reshard":
                assert got.read_bytes() == want.read_bytes(), rel


def test_without_pillow_video_refuses_and_audio_converts(raw, out, monkeypatch):
    cap = str(raw["captures"] / "class_0" / "data_003")
    want = jconvert.convert_capture_dir(cap, str(out / "jax"), classes=0, location=3, modalities=(1,))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.delitem(sys.modules, "PIL.Image", raising=False)
    img = np.zeros((120, 160, 3), np.uint8)
    calls = [
        lambda: pconvert.convert_capture_dir(cap, str(out / "video"), classes=0, location=3),
        lambda: pconvert.prepare_video_frame(img),
        lambda: pconvert._read_image(str(raw["collected"] / "14.png")),
        lambda: pconvert.convert_collected(str(raw["collected"]), str(out / "collected")),
        lambda: ptools.main(["convert-flickr", str(raw["flickr"]), str(out / "flickr")]),
    ]
    for call in calls:
        with pytest.raises(ImportError, match=r"Pillow.*--modalities 1"):
            call()
    got = pconvert.convert_capture_dir(cap, str(out / "port"), classes=0, location=3, modalities=(1,))
    _same_shards(got, want, out / "port", out / "jax")
    listed = pconvert.convert_flickr(str(raw["flickr"]), str(out / "flickr_audio"), modalities=(1,))
    assert len(_lines(listed)) == 2


def test_audio_tool_runs_without_pillow_or_cuda_code(raw, out):
    """``tools convert --modalities 1`` in a process where Pillow cannot be
    imported: it converts, and no kernel module, nvcc build or CUDA context
    is touched."""
    code = textwrap.dedent(
        f"""
        import sys
        sys.modules["PIL"] = None
        import torch
        from acoustic_image_generation_tpu_torch.cli import tools
        assert tools.main(["convert", {str(raw["captures"])!r}, {str(out / "port")!r}, "--modalities", "1"]) == 0
        cuda = sorted(m for m in sys.modules if m.startswith("acoustic_image_generation_tpu_torch.ops"))
        print(cuda, torch.cuda.is_initialized())
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "[] False"
    lists = json.loads(proc.stdout.splitlines()[-2])
    assert _lines(lists["training"]) and all(p.startswith(str(out / "port")) for p in _lines(lists["training"]))
