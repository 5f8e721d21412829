"""kNN classification in latent space: 15 neighbours, uniform votes.

Counterpart of ``acoustic_image_generation_tpu/evaluation/knn.py`` (the
reference's ``knn.py``): sklearn's ``KNeighborsClassifier(n_neighbors=k)``
with uniform weights; neighbours by ``distance.iter_nearest`` on ``device``
(a stable sort: the lowest gallery index wins a distance tie), votes on the
host, the lowest class winning a vote tie (``np.argmax`` of the counts).
"""

from __future__ import annotations

import numpy as np

from acoustic_image_generation_tpu_torch.evaluation.distance import as_feature_matrix, iter_nearest


def knn_accuracy(train_x, train_y, test_x, test_y, k: int = 15, *, chunk: int = 2048, device="cuda") -> float:
    """Accuracy of k-NN classification of ``test_x`` against ``train_x``,
    in ``chunk``-row blocks of the test set."""
    if len(test_y) == 0:
        return 0.0
    train_x, test_x = as_feature_matrix(train_x), as_feature_matrix(test_x)
    train_y, test_y = np.asarray(train_y), np.asarray(test_y)
    num_classes = int(max(train_y.max(), test_y.max())) + 1
    correct = 0
    for lo, nn_idx in iter_nearest(test_x, train_x, k, chunk, device):
        votes = train_y[nn_idx]  # (rows, k)
        counts = np.zeros((len(votes), num_classes), np.int64)
        np.add.at(counts, (np.arange(len(votes))[:, None], votes), 1)
        correct += int(np.sum(np.argmax(counts, axis=1) == test_y[lo:lo + len(votes)]))
    return correct / len(test_y)
