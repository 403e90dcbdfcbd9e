"""End-to-end driver on the PyTorch port: train a ~100M-parameter dense
LM for a few hundred steps on synthetic data with checkpointing +
auto-resume.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300               # one card
    PYTHONPATH=src python examples/torch_train_lm.py --steps 30 --device cpu

The port of ``examples/train_lm.py``, on the same config: a scaled-down
qwen2.5-family member (same code path as the full configs; see
``repro_torch/configs``).  Training runs no hand-written kernel, as the
reference's reaches no Pallas kernel; ``--device cuda`` (the default)
raises without a card.
"""
import argparse

from repro_torch import configs
from repro_torch.data import SyntheticLM
from repro_torch.optim import cosine_warmup
from repro_torch.train import Trainer, TrainerConfig, build
from repro_torch.tree import flatten


def lm_100m():
    return configs.get_config(
        "qwen2.5-3b",
        n_layers=12, d_model=640, n_heads=10, n_kv=2, d_ff=2560,
        head_dim=64, vocab_size=32000,
        param_dtype="float32", compute_dtype="float32", remat=False,
        attn_chunk_q=256, attn_chunk_kv=256, loss_chunk=0,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default="results/train_lm_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = lm_100m()
    state, step_fn = build(
        cfg, optimizer="adamw",
        lr=cosine_warmup(3e-4, warmup=20, total=args.steps), device=args.device,
    )
    n_params = sum(p.numel() for p in flatten(state["params"])[0])
    print(f"model: {cfg.name}-100m variant, {n_params / 1e6:.1f}M params")

    ds = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)
    tr = Trainer(
        state, step_fn, ds,
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                      ckpt_every=100, log_every=10, async_ckpt=True),
    )
    res = tr.run()
    for h in res["history"]:
        print(f"  step {h['step']:>4}  loss {h['loss']:.4f}  {h['sec'] * 1e3:.0f} ms")
    print(f"done at step {res['final_step']}; stragglers={res['stragglers']}; "
          f"checkpoints in {args.ckpt}")
    return {"n_params": n_params, "history": res["history"], "final_step": res["final_step"],
            "stragglers": res["stragglers"]}


if __name__ == "__main__":
    main()
