"""The port's MTA solver vs ``jcf_tpu.tta.solve_mta_batch``: f32 modes
within atol 1e-5, with each image's do-while exit rule kept per image."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from jcf_tpu.tta import solve_mta_batch as j_solve_batch
from jcf_tpu.tta.mta import solve_mta as j_solve
from jcf_tpu_torch.tta import mta as tmta

torch.set_num_threads(1)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _cloud(seed, b, n, d, c, spread):
    rng = np.random.default_rng(seed)
    center = rng.standard_normal((b, 1, d))
    feats = _unit(center + spread * rng.standard_normal((b, n, d)))
    text = _unit(rng.standard_normal((c, d)))
    return feats, text


@pytest.mark.parametrize("seed,b,n,spread", [
    (0, 4, 9, 0.3), (1, 6, 8, 1.0), (2, 3, 17, 0.05), (3, 5, 4, 2.0),
])
def test_solve_mta_batch_matches_jax(seed, b, n, spread):
    feats, text = _cloud(seed, b, n, 32, 10, spread)
    ref = np.asarray(j_solve_batch(jnp.asarray(feats), jnp.asarray(text)))
    got = tmta.solve_mta_batch(torch.from_numpy(feats), torch.from_numpy(text))
    assert got.shape == (b, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_per_image_exit_rules():
    """Images that converge at different steps in one batch give the
    same modes as each image solved alone."""
    tight, text = _cloud(4, 1, 8, 16, 6, 0.01)
    loose, _ = _cloud(5, 1, 8, 16, 6, 1.5)
    feats = np.concatenate([tight, loose])
    got = tmta.solve_mta_batch(torch.from_numpy(feats), torch.from_numpy(text))
    for i in range(2):
        alone = tmta.solve_mta(torch.from_numpy(feats[i]), torch.from_numpy(text))
        np.testing.assert_array_equal(got[i].numpy(), alone.numpy())
        ref = np.asarray(j_solve(jnp.asarray(feats[i]), jnp.asarray(text)))
        np.testing.assert_allclose(alone.numpy(), ref, atol=1e-5)
