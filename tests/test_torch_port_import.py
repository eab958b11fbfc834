"""The port stands alone: it imports and runs (the fused forward, a train
step, the DeepCache and sliding-window chains, a W8A8 chain, LPIPS and the
FLOP count, an SR3 forward, chain and DDIM chain, and a bf16 UNet with remat
included) with jax and the JAX package blocked, its sources import neither,
and its entry points refuse to run without CUDA unless the caller asks for
the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import diffsplitting_tpu_torch
from diffsplitting_tpu_torch import resolve_device
from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
from diffsplitting_tpu_torch.serving import SplittingModel

PKG = Path(diffsplitting_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "diffsplitting_tpu"}

BLOCKED_RUN = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "diffsplitting_tpu"):
    sys.modules[name] = None
import pkgutil, importlib
import diffsplitting_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import torch
# small ops: one thread, so that a loaded machine (the suite's other
# workers) does not oversubscribe the cores
torch.set_num_threads(1)
from diffsplitting_tpu_torch.config import dict_to_nonedict, load_json
from diffsplitting_tpu_torch.predict import predict_frames
from diffsplitting_tpu_torch.serving import SplittingModel
opt = dict_to_nonedict(load_json("configs/splitting_hagen_indi_joint.json"))
opt["model"]["beta_schedule"]["val"]["n_timestep"] = 1
model = SplittingModel(opt, device="cpu", seed=0)
frames = torch.randn(1, 32, 32, 1, generator=torch.Generator().manual_seed(0))
out = predict_frames(model, frames, patch=16, batch_size=8)
assert out.shape == (1, 32, 32, 2) and torch.isfinite(out).all()
# the stat-carried fused forward (ops/conv_gn.py, models/fused_forward.py)
from diffsplitting_tpu_torch.models import fused_unet_forward
from diffsplitting_tpu_torch.ops import conv_gn_fused
fused = predict_frames(model, frames, patch=16, batch_size=8, fused=True)
assert fused.shape == out.shape and torch.isfinite(fused).all()
# the trainer (diffusion losses, optim, clipping, EMA): one step on the CPU
import numpy as np
from diffsplitting_tpu_torch.train import DiffusionModel
opt["model"]["diffusion"]["image_size"] = 16
opt["train"]["optimizer"].update(grad_clip="auto", accum_steps=2,
                                 schedule={"type": "cosine", "warmup": 1})
opt["train"]["ema_scheduler"]["enabled"] = True
trainer = DiffusionModel(opt, device="cpu", seed=0)
rng = np.random.default_rng(0)
trainer.feed_data({"target": rng.normal(size=(2, 16, 16, 2)).astype(np.float32)})
trainer.optimize_parameters()
assert np.isfinite(trainer.get_current_log()["l_pix"])
# the time predictor with dropout on, and the t-refinement estimate
from diffsplitting_tpu_torch.models import TimePredictor, set_dropout_generator
from diffsplitting_tpu_torch.utils.t_refinement import estimate_time_using_PSNR
tp = TimePredictor(in_channel=1, out_channel=1, inner_channel=8, norm_groups=4,
                   channel_mults=(1, 2), attn_res=(), res_blocks=1, dropout=0.2,
                   image_size=16).train()
set_dropout_generator(tp, torch.Generator().manual_seed(0))
x = torch.randn(2, 16, 16, 1, generator=torch.Generator().manual_seed(1))
tp(x).sum().backward()
tp.eval()
per_sample, consensus = estimate_time_using_PSNR(
    x, model.process.indi1, model.process.indi2, *model.denoise_fns(),
    lambda a: tp(a).detach(), generator=torch.Generator().manual_seed(0))
assert per_sample.shape == (2,) and 0.0 <= consensus < 1.0
# the serving accelerators: one cached chain and one windowed chain
model.set_deepcache(2)
cached = model.test(x)
model.set_deepcache(None)
model.set_sliding_window(2, 0.0)
windowed = model.test(x)
assert cached.shape == windowed.shape == (2, 16, 16, 2)
assert torch.isfinite(cached).all() and torch.isfinite(windowed).all()
assert model.last_sliding_sweeps == 2 * model.process.val_num_timesteps
# W8A8 (ops/quant.py, models/quant_unet.py): one quantized chain; LPIPS, FLOPs
model.set_sliding_window(None)
model.set_quant(8, calib=2)
quantized = model.test(x)
assert quantized.shape == (2, 16, 16, 2) and torch.isfinite(quantized).all()
model.set_quant(None)
from diffsplitting_tpu_torch.utils import lpips
from diffsplitting_tpu_torch.utils.flops import config_forward_flops
lp = lpips.random_lpips_params(torch.Generator().manual_seed(0))
assert lpips.lpips_grayscale(lp, x.repeat(1, 4, 4, 1), -x.repeat(1, 4, 4, 1)).shape == (2,)
assert config_forward_flops(opt["model"], 16) > 0
# SR3: the noise-level UNet, one forward and a 2-step chain
from diffsplitting_tpu_torch.diffusion import SR3Process, build_ddpm_schedule
from diffsplitting_tpu_torch.models import UNet
sr3 = UNet(in_channel=6, out_channel=3, inner_channel=8, norm_groups=4, channel_mults=(1, 2),
           attn_res=(8,), res_blocks=1, image_size=16, cond_type="noise_level").eval()
cond = torch.randn(1, 16, 16, 3, generator=torch.Generator().manual_seed(2))
with torch.no_grad():
    assert sr3(torch.cat([cond, cond], -1), torch.full((1,), 0.5)).shape == (1, 16, 16, 3)
sched = build_ddpm_schedule({"schedule": "linear", "n_timestep": 2, "linear_start": 1e-6,
                             "linear_end": 1e-2})
chain = SR3Process(16).p_sample_loop(sr3, sched, cond, continuous=True,
                                     generator=torch.Generator().manual_seed(0))
assert chain.shape == (3, 1, 16, 16, 3) and torch.isfinite(chain).all()
# respaced DDIM (diffusion/ddim.py): one step of the 2-step schedule
from diffsplitting_tpu_torch.diffusion.ddim import ddim_sample_loop
respaced = ddim_sample_loop(SR3Process(16), sr3, sched, cond, 1, 1.0,
                            generator=torch.Generator().manual_seed(0))
assert respaced.shape == (1, 16, 16, 3) and torch.isfinite(respaced).all()
# bf16 and remat (models/precision.py): a remat backward at dropout 0.2, and
# the precast copy's forward
from diffsplitting_tpu_torch.models.precision import cast_unet_params_for_inference
b16 = UNet(in_channel=6, out_channel=3, inner_channel=8, norm_groups=4, channel_mults=(1, 2),
           attn_res=(8,), res_blocks=1, image_size=16, cond_type="noise_level",
           dtype=torch.bfloat16, remat=True, dropout=0.2).train()
set_dropout_generator(b16, torch.Generator().manual_seed(0))
x6, lvl = torch.cat([cond, cond], -1), torch.full((1,), 0.5)
b16(x6, lvl).sum().backward()
assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in b16.parameters())
b16.eval()
with torch.no_grad():
    assert torch.equal(cast_unet_params_for_inference(b16)(x6, lvl), b16(x6, lvl))
print("OK")
"""


def test_package_imports_and_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_sources_import_no_jax():
    found = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [(path.name, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not found


def test_entry_points_need_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    opt = dict_to_nonedict(load_json(str(ROOT / "configs/splitting_hagen_indi_joint.json")))
    with pytest.raises(RuntimeError, match="CUDA"):
        SplittingModel(opt)
