"""The port's metric losses against the JAX package, in f32 on the CPU:
values and gradients with respect to both embeddings, on labels and
scenarios that give same-class and different-class pairs.

Tolerances: the same f32 arithmetic reduced in another order, 1e-5
relative on values and gradients (1e-6 absolute for entries near 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.losses import metric as jmetric
from acoustic_image_generation_tpu_torch.losses import metric
from torch_threads import few_torch_threads  # noqa: F401

B, D = 8, 16
LABELS = {
    "mixed": (np.array([0, 1, 0, 2, 1, 0, 3, 2]), np.array([0, 0, 0, 0, 1, 0, 0, 0])),
    "all_same": (np.zeros(B, int), np.zeros(B, int)),
    "all_different": (np.arange(B), np.zeros(B, int)),
}
LOSSES = {
    "triplet_hard": lambda m, a, b, l, s: m.triplet_hard(a, b, l, s, 0.2),
    "triplet_all": lambda m, a, b, l, s: m.triplet_all(a, b, l, s, 0.2),
    "nca": lambda m, a, b, l, s: (m.nca_loss(a, b, l, s), 0.0),
    "distances": lambda m, a, b, l, s: (m.pairwise_sq_distances(a, b).sum(), 0.0),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, D)).astype(np.float32)
    b = (a + 0.7 * rng.standard_normal((B, D))).astype(np.float32)
    return a, b


@pytest.mark.parametrize("labels", list(LABELS))
@pytest.mark.parametrize("loss", list(LOSSES))
def test_metric_loss_and_grads_match_jax(loss, labels):
    a, b = _inputs(0)
    lab, scen = LABELS[labels]
    fn = LOSSES[loss]

    def jax_fn(a, b):
        value, aux = fn(jmetric, a, b, jnp.asarray(lab), jnp.asarray(scen))
        return value, aux

    (want, want_aux), (ga, gb) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    got, got_aux = fn(metric, ta, tb, torch.from_numpy(lab), torch.from_numpy(scen))
    got.backward()
    assert got.dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **tol)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), **tol)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), **tol)


def test_masks_and_the_distance_quirk():
    lab, scen = (torch.from_numpy(x) for x in LABELS["mixed"])
    pos, neg = metric.positive_negative_masks(lab, scen)
    jpos, jneg = jmetric.positive_negative_masks(jnp.asarray(lab.numpy()), jnp.asarray(scen.numpy()))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))
    np.testing.assert_array_equal(metric._triplet_mask(lab, scen).numpy(),
                                  np.asarray(jmetric._triplet_mask(jnp.asarray(lab.numpy()),
                                                                   jnp.asarray(scen.numpy()))))
    # only the diagonal is a true pair distance (the reference's expansion)
    a, b = (torch.from_numpy(x) for x in _inputs(1))
    d = metric.pairwise_sq_distances(a, b)
    np.testing.assert_allclose(torch.diagonal(d).numpy(), ((a - b) ** 2).sum(1).numpy(), rtol=1e-5)
    assert not np.allclose(d[0, 1].item(), ((a[0] - b[1]) ** 2).sum().item(), rtol=1e-3)
