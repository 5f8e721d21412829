"""Cross-modal retrieval: ranks 1, 2, 5, 10 and 30, and the rank-1
confusion.

Counterpart of ``acoustic_image_generation_tpu/evaluation/retrieve.py``
(the reference's ``retrieve.py``): for each anchor embedding the other
modality's gallery sorted by distance (``distance.iter_nearest`` on
``device``, ties by gallery index); a hit at rank k when an item of the
anchor's class is among the first k.
"""

from __future__ import annotations

import numpy as np

from acoustic_image_generation_tpu_torch.evaluation.distance import as_feature_matrix, iter_nearest

RANKS = (1, 2, 5, 10, 30)


def retrieval_ranks(anchors, anchor_labels, gallery, gallery_labels, num_classes: int, *, chunk: int = 2048,
                    device="cuda") -> dict:
    """``{"rank1": ..., "rank30": fraction of anchors with a hit,
    "confusion_rank1": (classes, classes) counts of (anchor class, class
    of the nearest item)}``."""
    anchors, gallery = as_feature_matrix(anchors), as_feature_matrix(gallery)
    anchor_labels, gallery_labels = np.asarray(anchor_labels), np.asarray(gallery_labels)
    hits = dict.fromkeys(RANKS, 0)
    confusion1 = np.zeros((num_classes, num_classes), dtype=float)
    for lo, order in iter_nearest(anchors, gallery, max(RANKS), chunk, device):
        ranked = gallery_labels[order]  # (rows, 30)
        mine = anchor_labels[lo:lo + len(order)]
        np.add.at(confusion1, (mine, ranked[:, 0]), 1)
        for k in RANKS:
            hits[k] += int(np.sum(np.any(ranked[:, :k] == mine[:, None], axis=1)))
    n = max(len(anchors), 1)
    out = {f"rank{k}": hits[k] / n for k in RANKS}
    out["confusion_rank1"] = confusion1
    return out
