"""``T2IEngine.sample`` against the JAX engine's ``_sample_fn`` on shared
parameters (``test_torch_t2i``'s tiny engine) and the same initial noise:
DDIM, PLMS and DPM-Solver++(2M) with the CFG pair at the tool's scale 7.5,
then the VAE decode and the clip to [0, 1]; and the JAX rule that any other
sampler name runs DDIM."""

import numpy as np
import pytest
import torch

from test_torch_t2i import jax_engine, sample_cores

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def engines():
    return jax_engine(tokenizer=None)


@pytest.mark.parametrize("sampler,steps", [("ddim", 3), ("plms", 3),
                                           ("dpmpp", 2)])
def test_sample_core_matches_jax(engines, sampler, steps):
    jeng, eng = engines
    got, ref = sample_cores(jeng, eng, sampler, steps, seed=6)
    assert got.shape == (2, 8, 8, 3)
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.std() > 0.0
    # steps x 2N UNet evals at scale 7.5 and the VAE decoder, f32 on shared
    # weights: 1e-4 absolute on images in [0, 1]
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_unknown_sampler_runs_ddim(engines):
    _, eng = engines
    x_T = torch.from_numpy(np.random.RandomState(8).randn(1, 4, 8, 8)
                           .astype(np.float32))
    ctx = torch.from_numpy(np.random.RandomState(9).randn(1, 16, 32)
                           .astype(np.float32))
    torch.testing.assert_close(eng.sample(ctx, ctx, x_T, 7.5, 2, "euler"),
                               eng.sample(ctx, ctx, x_T, 7.5, 2, "ddim"),
                               rtol=0, atol=0)
