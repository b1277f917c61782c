"""The port's latent-factor samplers against the JAX package's: the same
numpy streams in the same order, so every array is bit-equal."""
import numpy as np
import pytest

from coldrec_tpu.data import synthetic as jsyn
from coldrec_tpu_torch.data import synthetic as tsyn
from test_torch_threads import torch_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("kw", [
    dict(n_users=300, n_items=200, nnz=6000, seed=0),
    dict(n_users=120, n_items=400, nnz=2400, seed=3, rank=8, alpha=2.0,
         pop_exponent=0.5, degree_a=1.2, min_degree=3),
    # coverage repair: more items than a light log reaches
    dict(n_users=80, n_items=600, nnz=2400, seed=5),
])
def test_latent_interactions_bit_equal(kw):
    for got, want in zip(tsyn.latent_interactions(**kw),
                         jsyn.latent_interactions(**kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim,noise,seed", [(206, 0.7, 0), (16, 0.0, 4)])
def test_latent_content_bit_equal(dim, noise, seed):
    _, _, vf = tsyn.latent_interactions(150, 120, 3000, seed=1)
    got = tsyn.latent_content(vf, dim, seed=seed, noise=noise)
    want = jsyn.latent_content(vf, dim, seed=seed, noise=noise)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_latent_interactions_refuses_an_unreachable_count():
    with pytest.raises(ValueError, match="outside the achievable range"):
        tsyn.latent_interactions(10, 20, 10_000)
