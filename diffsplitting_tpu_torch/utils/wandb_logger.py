"""Weights & Biases experiment logging.

Counterpart: diffsplitting_tpu/utils/wandb_logger.py (init with
project/config/dir/name, log_metrics, images, checkpoint artifacts, the eval
and infer tables), as far as split.py, infer.py and sample.py use it. `wandb` is imported when a logger is made, never at
module import; where it is not installed, making a logger raises (the JAX
package writes a JSONL file instead: here there is no silent substitute).
"""

from __future__ import annotations

import os


class WandbLogger:
    def __init__(self, opt, logdir, name):
        try:
            import wandb
        except ImportError as err:
            raise RuntimeError("-enable_wandb needs the wandb package, which is not "
                               "installed; run without -enable_wandb") from err
        self._wandb = wandb
        self._opt = opt
        if wandb.run is None:
            wandb.init(project=opt["wandb"]["project"], config=dict(opt), dir=logdir, name=name)
        self.config = wandb.config
        self.eval_table = self.infer_table = None
        if self.config.get("log_eval", None):
            self.eval_table = wandb.Table(
                columns=["fake_image", "sr_image", "hr_image", "psnr", "ssim"])
        if self.config.get("log_infer", None):
            self.infer_table = wandb.Table(columns=["fake_image", "sr_image", "hr_image"])

    def log_metrics(self, metrics, commit=True):
        self._wandb.log(metrics, commit=commit)

    def log_image(self, key_name, image_array):
        self._wandb.log({key_name: self._wandb.Image(image_array)})

    def log_images(self, key_name, list_images):
        self._wandb.log({key_name: [self._wandb.Image(img) for img in list_images]})

    def log_checkpoint(self, current_epoch, current_step):
        """The `I{step}_E{epoch}` checkpoint pair as a model artifact."""
        ckpt_dir = self._opt["path"]["checkpoint"]
        artifact = self._wandb.Artifact(self._wandb.run.id + "_model", type="model")
        for suffix in ("_gen.pth", "_opt.pth"):
            path = os.path.join(ckpt_dir, f"I{current_step}_E{current_epoch}{suffix}")
            if os.path.exists(path):
                artifact.add_file(path)
        self._wandb.log_artifact(artifact, aliases=["latest"])

    def log_eval_data(self, fake_img, sr_img, hr_img, psnr=None, ssim=None):
        """A row of the eval table (with psnr and ssim) or of the infer table."""
        img = self._wandb.Image
        if psnr is not None and ssim is not None and self.eval_table is not None:
            self.eval_table.add_data(img(fake_img), img(sr_img), img(hr_img), psnr, ssim)
        elif self.infer_table is not None:
            self.infer_table.add_data(img(fake_img), img(sr_img), img(hr_img))

    def log_eval_table(self, commit=False):
        if self.eval_table:
            self._wandb.log({"eval_data": self.eval_table}, commit=commit)
        elif self.infer_table:
            self._wandb.log({"infer_data": self.infer_table}, commit=commit)
