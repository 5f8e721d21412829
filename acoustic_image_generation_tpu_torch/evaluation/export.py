"""Latent feature export for kNN and retrieval.

Counterpart of ``acoustic_image_generation_tpu/evaluation/export.py`` (the
reference's ``extract_features_unetraces.py`` and ``extract_triplet.py``
layout): per split and modality a directory ``{set}_{modality}_{epoch}/``
holding ``{set}_data.npy``, ``{set}_labels.npy`` (one-hot, f32) and
``{set}_scenario.npy`` (one-hot, f32), the same files byte for byte."""

from __future__ import annotations

import os

import numpy as np


def export_features(
    out_root: str,
    split: str,
    modality: str,
    epoch,
    features: np.ndarray,
    labels: np.ndarray,
    scenario: np.ndarray,
    num_classes: int,
    num_locations: int,
) -> str:
    data_dir = os.path.join(out_root, f"{split}_{modality}_{epoch}")
    os.makedirs(data_dir, exist_ok=True)
    labels = np.asarray(labels)
    onehot = np.eye(num_classes, dtype=np.float32)[labels]
    scen = np.eye(num_locations, dtype=np.float32)[np.asarray(scenario)]
    np.save(os.path.join(data_dir, f"{split}_data.npy"), np.asarray(features))
    np.save(os.path.join(data_dir, f"{split}_labels.npy"), onehot)
    np.save(os.path.join(data_dir, f"{split}_scenario.npy"), scen)
    return data_dir


def load_features(data_dir: str, split: str):
    features = np.load(os.path.join(data_dir, f"{split}_data.npy"))
    labels = np.argmax(np.load(os.path.join(data_dir, f"{split}_labels.npy")), axis=1)
    scen_path = os.path.join(data_dir, f"{split}_scenario.npy")
    scenario = np.argmax(np.load(scen_path), axis=1) if os.path.exists(scen_path) else None
    return features, labels, scenario
