"""The port's beta schedules and DDPM schedule against the JAX package's.

Both compute in float64 numpy, so `make_beta_schedule` must agree bit for
bit in every mode; `build_ddpm_schedule` casts each field to float32 from the
same float64 values, so every field must equal JAX's bit for bit too, with
the same dtype (f32) and length (T, and T + 1 for `sqrt_alphas_cumprod_prev`).
"""

import numpy as np
import pytest
import torch

from diffsplitting_tpu.diffusion import schedules as jax_schedules
from diffsplitting_tpu_torch.diffusion import schedules

MODES = ["quad", "linear", "warmup10", "warmup50", "const", "jsd", "cosine"]
FIELDS = [f for f in schedules.DDPMSchedule.__dataclass_fields__ if f != "num_timesteps"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [10, 2000])
def test_beta_schedule_matches_jax_bit_for_bit(mode, n):
    got = schedules.make_beta_schedule(mode, n, 1e-6, 1e-2)
    want = jax_schedules.make_beta_schedule(mode, n, 1e-6, 1e-2)
    assert got.dtype == want.dtype == np.float64 and got.shape == (n,)
    np.testing.assert_array_equal(got, want)


def test_unknown_schedule_raises():
    with pytest.raises(NotImplementedError):
        schedules.make_beta_schedule("sigmoid", 10)


@pytest.mark.parametrize("opt", [
    {"schedule": "linear", "n_timestep": 2000, "linear_start": 1e-6, "linear_end": 1e-2},
    {"schedule": "linear", "n_timestep": 2000, "linear_start": 1e-4, "linear_end": 2e-2},
    {"schedule": "cosine", "n_timestep": 50, "linear_start": 1e-4, "linear_end": 2e-2},
    {"schedule": "quad", "n_timestep": 7, "linear_start": 1e-4, "linear_end": 2e-2},
], ids=["sr3", "ddpm", "cosine", "quad"])
def test_ddpm_schedule_fields_match_jax(opt):
    got = schedules.build_ddpm_schedule(opt)
    want = jax_schedules.build_ddpm_schedule(opt)
    assert got.num_timesteps == want.num_timesteps == opt["n_timestep"]
    assert set(FIELDS) == set(want.__dataclass_fields__) - {"num_timesteps"}
    for f in FIELDS:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == torch.float32 and w.dtype == np.float32, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    assert got.sqrt_alphas_cumprod_prev.shape == (opt["n_timestep"] + 1,)
    moved = got.to("cpu")
    assert moved.num_timesteps == got.num_timesteps and torch.equal(moved.betas, got.betas)
