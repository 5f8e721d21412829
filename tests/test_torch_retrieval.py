"""The latent-space evaluations against the JAX package's, on the same
arrays, on the CPU: the nearest neighbours of ``evaluation/distance.py``,
the kNN accuracy, the retrieval ranks and rank-1 confusion, the feature
export's files, the trimmed-mean aggregation and its ``.xlsx``.

Every comparison is exact. The squared norms are numpy's on both sides and
the products the same f32 GEMM, so the distances, and with a stable sort
the neighbours, are JAX's; the cases include exact ties (duplicated gallery
rows, queries equal to gallery rows) and sizes on either side of ``chunk``.
"""

import json
import os
import zipfile

import numpy as np
import pytest

from acoustic_image_generation_tpu.evaluation import aggregate as jaggregate
from acoustic_image_generation_tpu.evaluation import distance as jdistance
from acoustic_image_generation_tpu.evaluation import export as jexport
from acoustic_image_generation_tpu.evaluation import knn as jknn
from acoustic_image_generation_tpu.evaluation import retrieve as jretrieve
from acoustic_image_generation_tpu.utils import xlsx as jxlsx
from acoustic_image_generation_tpu_torch.evaluation import aggregate, distance, export, knn, retrieve
from acoustic_image_generation_tpu_torch.utils import xlsx
from torch_threads import few_torch_threads  # noqa: F401


def _case(seed, n_gallery, n_query, dim, classes):
    """Gallery and queries with exact ties: a third of the gallery rows
    duplicated, a quarter of the queries copied from the gallery."""
    rng = np.random.default_rng(seed)
    gallery = rng.normal(size=(n_gallery, dim)).astype(np.float32)
    gallery[rng.integers(0, n_gallery, n_gallery // 3)] = gallery[rng.integers(0, n_gallery, n_gallery // 3)]
    queries = rng.normal(size=(n_query, dim)).astype(np.float32)
    queries[: n_query // 4] = gallery[rng.integers(0, n_gallery, n_query // 4)]
    return gallery, rng.integers(0, classes, n_gallery), queries, rng.integers(0, classes, n_query)


CASES = [(0, 40, 30, 16, 3), (1, 300, 129, 128, 10), (2, 7, 64, 3, 2), (3, 150, 257, 40, 9)]
CHUNKS = [7, 64, 128, 2048]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_nearest_neighbours_are_jaxs(case):
    gallery, _, queries, _ = _case(*case)
    for chunk in CHUNKS:
        blocks = list(distance.iter_nearest(queries, gallery, 30, chunk, device="cpu"))
        want = list(jdistance.iter_sq_distance_blocks(queries, gallery, chunk))
        assert [lo for lo, _ in blocks] == [lo for lo, _ in want]
        for (_, idx), (_, d) in zip(blocks, want):
            np.testing.assert_array_equal(idx, np.argsort(d, axis=1, kind="stable")[:, :30])
    assert distance.as_feature_matrix(np.zeros((2, 3, 4), np.float64)).shape == (2, 12)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_knn_and_retrieval_equal_jax(case):
    gallery, g_labels, queries, q_labels = _case(*case)
    classes = case[-1]
    for chunk in CHUNKS:
        for k in (1, 5, 15):
            assert knn.knn_accuracy(gallery, g_labels, queries, q_labels, k, chunk=chunk, device="cpu") == \
                jknn.knn_accuracy(gallery, g_labels, queries, q_labels, k, chunk=chunk)
        got = retrieve.retrieval_ranks(queries, q_labels, gallery, g_labels, classes, chunk=chunk, device="cpu")
        want = jretrieve.retrieval_ranks(queries, q_labels, gallery, g_labels, classes, chunk=chunk)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert knn.knn_accuracy(gallery, g_labels, queries[:0], q_labels[:0], device="cpu") == 0.0


def test_export_files_are_jaxs_byte_for_byte(tmp_path):
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(9, 128)).astype(np.float32)
    labels, scenario = rng.integers(0, 10, 9), rng.integers(0, 61, 9)
    got = export.export_features(str(tmp_path / "port"), "testing", "audio", 7, feats, labels, scenario, 10, 61)
    want = jexport.export_features(str(tmp_path / "jax"), "testing", "audio", 7, feats, labels, scenario, 10, 61)
    assert os.path.basename(got) == os.path.basename(want) == "testing_audio_7"
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    for name in os.listdir(want):
        assert open(os.path.join(got, name), "rb").read() == open(os.path.join(want, name), "rb").read(), name
    for a, b in zip(export.load_features(got, "testing"), jexport.load_features(want, "testing")):
        np.testing.assert_array_equal(a, b)


def test_aggregate_and_xlsx_are_jaxs(tmp_path):
    values = {"knn": [0.5, 0.7, 0.65, 0.9, 0.1], "rank1": [0.3, 0.31], "auc": [np.float64(0.25)]}
    assert aggregate.trimmed_mean_std(values["knn"]) == jaggregate.trimmed_mean_std(values["knn"])
    for suffix in (".json", ".xlsx"):
        got = aggregate.aggregate_runs(values, str(tmp_path / f"port{suffix}"))
        assert got == jaggregate.aggregate_runs(values, str(tmp_path / f"jax{suffix}"))
    assert json.load(open(tmp_path / "port.json")) == json.load(open(tmp_path / "jax.json"))
    assert xlsx.read_xlsx_rows(str(tmp_path / "port.xlsx")) == jxlsx.read_xlsx_rows(str(tmp_path / "jax.xlsx"))
    rows = [["name", "x", "n"], ["a<&>", np.float32(1.5), np.int64(3)], [True, 2.0, 10**12]]
    xlsx.write_xlsx(str(tmp_path / "p.xlsx"), rows, sheet_name="s&1")
    jxlsx.write_xlsx(str(tmp_path / "j.xlsx"), rows, sheet_name="s&1")
    with zipfile.ZipFile(tmp_path / "p.xlsx") as p, zipfile.ZipFile(tmp_path / "j.xlsx") as j:
        assert p.namelist() == j.namelist()
        assert all(p.read(n) == j.read(n) for n in j.namelist())
