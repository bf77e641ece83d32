"""Quickstart of the PyTorch port: train a llama-family model with the full
training stack (AdamW, two-microbatch gradient accumulation, async
checkpoints) on one GPU, or on the CPU when asked.

  PYTHONPATH=src python examples/torch_quickstart.py                 # CUDA
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
  PYTHONPATH=src python examples/torch_quickstart.py --config tinyllama-1.1b --lr 3e-5 --steps 10

By default the model is TinyLlama reduced to 2 layers (d 64), trained for
60 steps on ``SyntheticTokens`` (batch 8 x 64 tokens) at lr 1e-2 with a
10-step warmup, a checkpoint every 10 steps.  ``--config`` names a config
at its full width (its weights random from ``init_params(seed=0)``).  At
full width TinyLlama-1.1B's loss rises at lr 1e-2; 3e-5 trains it.
"""
import argparse
import tempfile
import time

from repro_torch import resolve_device
from repro_torch.configs import CONFIGS, get_config, reduced
from repro_torch.models import init_params
from repro_torch.training import checkpoint, data, optimizer, train_step

ARCH = "tinyllama-1.1b"
STEPS, LR, WARMUP, TOTAL = 60, 1e-2, 10, 200
BATCH, SEQ, NUM_MICRO, CKPT_EVERY = 8, 64, 2, 10


def reduced_config():
    return reduced(CONFIGS[ARCH], num_layers=2)


def run(cfg, params, *, device="cuda", steps: int = STEPS, lr: float = LR,
        ckpt_dir: str | None = None, on_step=None) -> dict:
    """Train ``params`` (on ``device``) for ``steps`` AdamW steps with
    NUM_MICRO microbatches, submitting a checkpoint every CKPT_EVERY
    steps to ``ckpt_dir`` (a temporary directory if None).  ``on_step(step,
    params, stats)`` runs after each step.  Returns the per-step losses and
    host seconds, and the latest checkpoint step on disk."""
    dev = resolve_device(device)
    opt_cfg = optimizer.AdamWConfig(lr=lr, warmup_steps=WARMUP,
                                    total_steps=TOTAL)
    opt = optimizer.init_opt_state(params)
    ds = data.SyntheticTokens(cfg, batch=BATCH, seq_len=SEQ)
    step_fn = train_step.make_train_step(cfg, opt_cfg, num_micro=NUM_MICRO,
                                         device=dev)
    out = {"losses": [], "step_s": []}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = ckpt_dir or tmp
        ck = checkpoint.AsyncCheckpointer(ckpt_dir)
        for step in range(steps):
            t0 = time.perf_counter()
            params, opt, stats = step_fn(params, opt, ds.batch_at(step))
            out["losses"].append(float(stats["loss"]))
            out["step_s"].append(time.perf_counter() - t0)
            if on_step is not None:
                on_step(step, params, stats)
            if step % CKPT_EVERY == 0:
                ck.submit(step, {"params": params, "opt": opt})
                print(f"step {step:3d}  loss {out['losses'][-1]:.3f}  "
                      f"lr {float(stats['lr']):.2e}  "
                      f"|g| {float(stats['grad_norm']):.2f}")
        ck.close()
        out["latest_step"] = checkpoint.latest_step(ckpt_dir)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default=None,
                    help="a config name at full width (default: TinyLlama "
                         "reduced to 2 layers)")
    ap.add_argument("--lr", type=float, default=LR)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = get_config(args.config) if args.config else reduced_config()
    print(f"config: {cfg.name} ({cfg.num_layers}L, d={cfg.d_model}) on {dev}")
    params = init_params(cfg, seed=0, device=dev)
    res = run(cfg, params, device=dev, steps=args.steps, lr=args.lr)
    print(f"latest checkpoint: step {res['latest_step']}")
    print("done -- loss should have descended (reduced: from ~6.0 toward "
          "~4.0)")


if __name__ == "__main__":
    main()
