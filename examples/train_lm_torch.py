"""End-to-end training run of the PyTorch/CUDA port: a ~15M-param
minicpm-family model for a few hundred steps with checkpoint/restart
(kill-safe) and the WSD schedule, through the port's launch path
(repro_torch.launch.train), as examples/train_lm.py does for the
reference.

Run:  PYTHONPATH=src python examples/train_lm_torch.py          # on a GPU
      PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.base import register
from repro_torch.launch.train import main as train_main

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm_ckpt")
shutil.rmtree(CKPT, ignore_errors=True)

# a ~15M-param member of the minicpm family (WSD schedule)
cfg = get_config("minicpm-2b")
small = cfg.with_(name="minicpm-15m", num_layers=4, d_model=256,
                  num_heads=4, num_kv_heads=4, d_ff=1024, head_dim=64,
                  vocab_size=8192, compute_dtype="float32",
                  param_dtype="float32")
register(small)

common = ["--arch", "minicpm-15m", "--batch", "8", "--seq", "128", "--lr",
          "3e-3", "--ckpt", CKPT, "--device", args.device]
losses = train_main(common + ["--steps", "200", "--ckpt-every", "50"])
assert losses[-1] < losses[0] * 0.5, "loss should fall substantially"
print(f"trained 200 steps: loss {losses[0]:.3f} -> {losses[-1]:.3f}")

# restart from the latest checkpoint and continue (fault-tolerance demo)
more = train_main(common + ["--steps", "220"])
print(f"resumed from step 200 and reached step 220; "
      f"final loss {more[-1]:.3f}")
