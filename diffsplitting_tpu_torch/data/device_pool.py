"""Device-resident random-patch pool: training batches drawn on the card.

Counterpart: diffsplitting_tpu/data/device_pool.py (`DevicePatchPool`). The
normalized-source frame stacks move to the device once, at construction, and
every batch is drawn there from a seeded device `torch.Generator`, with the
semantics of `SplitDataset.__getitem__` on a random-patching dataset:

  * frame uniform over the F frames; with `uncorrelated_channels`, channel 2
    from a frame drawn independently;
  * offsets uniform over [0, H - P) and [0, W - P) (exclusive high, as
    `np.random.Generator.integers`), 0 where the frame is the patch's size;
  * a paired horizontal flip with p = 0.5 when the dataset's transforms are on;
  * target = the channel patches concatenated, normalized by the target
    statistics; input = the weighted sum of the normalized target
    (`input_from_normalized_target`, joint-InDI) or the normalized weighted
    sum of the raw patches;
  * `target_channel_idx` keeps one target channel.

Torch cannot replay the JAX pool's threefry stream, nor the dataset's numpy
stream, so the pool is held to those semantics, not to their bits. The
arithmetic runs in float32 on the device; the numpy dataset normalizes with
float64 statistics before its cast to float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import resolve_device


class DevicePatchPool:
    """Draws batches of `batch_size` random patches from the frame stacks of
    `dataset` (a random-patching `SplitDataset`), on `device` (default: the
    card)."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, device=None):
        dev = resolve_device(device)
        P, F = int(dataset._patch_size), int(dataset._frameN)
        stack0 = np.stack([np.asarray(f, np.float32) for f in dataset._data_dict[0][:F]])
        stack1 = np.stack([np.asarray(f, np.float32) for f in dataset._data_dict[1][:F]])
        if stack0.ndim == 3:  # (F, H, W) grayscale -> (F, H, W, 1)
            stack0, stack1 = stack0[..., None], stack1[..., None]
        if stack0.shape != stack1.shape:
            raise ValueError(f"channel stacks differ: {stack0.shape} vs {stack1.shape}")
        _, H, W, C = stack0.shape
        if H < P or W < P:
            raise ValueError(f"patch {P} exceeds frame {H}x{W}")

        self.batch_size, self.patch_size, self.frames, self.channels = int(batch_size), P, F, C
        self.height, self.width = H, W
        self.uncorrelated = bool(dataset._uncorrelated_channels)
        self.transforms = bool(dataset._enable_transforms)
        self.from_norm_target = bool(dataset._input_from_normalized_target)
        self.target_channel_idx = dataset._target_channel_idx
        self.channel_weights = tuple(float(w) for w in dataset._channel_weights[:2])
        self.mean_target = torch.tensor(np.asarray(dataset._mean_target, np.float32).reshape(-1),
                                        device=dev)
        self.std_target = torch.tensor(np.asarray(dataset._std_target, np.float32).reshape(-1),
                                       device=dev)
        self.mean_input = float(np.float32(dataset._mean_inp))
        self.std_input = float(np.float32(dataset._std_inp))
        # one upload of each stack
        self.stack0 = torch.from_numpy(stack0).to(dev)
        self.stack1 = torch.from_numpy(stack1).to(dev)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self._rows = torch.arange(P, device=dev)

    @property
    def device(self) -> torch.device:
        return self.stack0.device

    def sample_locations(self) -> Dict[str, torch.Tensor]:
        """One batch's frames `f1`, `f2`, offsets `h`, `w` and `flip`
        (bool), each (B,) on the device."""
        B, P, g, dev = self.batch_size, self.patch_size, self.generator, self.device

        def randint(high):
            if high <= 0:
                return torch.zeros(B, dtype=torch.int64, device=dev)
            return torch.randint(0, high, (B,), generator=g, device=dev)

        f1 = randint(self.frames)
        f2 = randint(self.frames) if self.uncorrelated else f1
        h = randint(self.height - P)
        w = randint(self.width - P)
        flip = (torch.rand(B, generator=g, device=dev) < 0.5 if self.transforms
                else torch.zeros(B, dtype=torch.bool, device=dev))
        return {"f1": f1, "f2": f2, "h": h, "w": w, "flip": flip}

    def batch_at(self, loc: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The {'input', 'target'} NHWC batch at `loc` (`sample_locations`)."""
        C = self.channels
        rows = (loc["h"][:, None] + self._rows)[:, :, None]  # (B, P, 1)
        cols = (loc["w"][:, None] + self._rows)[:, None, :]  # (B, 1, P)
        flip = loc["flip"][:, None, None, None]

        def cut(stack, f):
            p = stack[f[:, None, None], rows, cols]  # (B, P, P, C)
            return torch.where(flip, p.flip(2), p)

        p1, p2 = cut(self.stack0, loc["f1"]), cut(self.stack1, loc["f2"])
        target = (torch.cat([p1, p2], dim=-1) - self.mean_target) / self.std_target
        w0, w1 = self.channel_weights
        if self.from_norm_target:
            inp = w0 * target[..., 0:C] + w1 * target[..., C:2 * C]
        else:
            inp = (w0 * p1 + w1 * p2 - self.mean_input) / self.std_input
        if self.target_channel_idx is not None:
            c = self.target_channel_idx
            target = target[..., c:c + 1]
        return {"input": inp, "target": target}

    def draw(self) -> Dict[str, torch.Tensor]:
        """One batch on the device; advances the pool's generator."""
        return self.batch_at(self.sample_locations())
