"""Training on the PyTorch port: pretrain a target on the domain mixture
and fine-tune one drafter per domain (the paper's knowledge-distillation
setup, reproduced with real gradient descent), save checkpoints in the
reference's msgpack format, then measure the Table-2-style acceptance
matrix.

  PYTHONPATH=src python examples/torch_train_drafters.py --steps 150 \
      [--out checkpoints] [--device cuda|cpu]

Runs on CUDA unless `--device cpu` is given: every attention forward of
a training step on the hand-written flash-attention kernel, with its
gradient. The checkpoints serve with
`python -m repro_torch.launch.serve --ckpt-dir checkpoints`, and load in
the JAX package too.
"""
import argparse
import os

from repro_torch.checkpoint.store import save_checkpoint
from repro_torch.config import CoSineConfig
from repro_torch.configs.drafters import tiny_drafter, tiny_target
from repro_torch.data.synthetic import DOMAINS, SyntheticCorpus
from repro_torch.launch.train import train_model
from repro_torch.serving.engine import SpeculativeEngine

VOCAB = 96


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--out", type=str, default="checkpoints")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()

    corpus = SyntheticCorpus(VOCAB, seed=0, sharpness=60.0, support=6)
    tcfg, dcfg = tiny_target(VOCAB), tiny_drafter(VOCAB)

    tparams, _ = train_model(tcfg, corpus, None, args.steps * 2, batch=16,
                             seq=64, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    save_checkpoint(os.path.join(args.out, "target.msgpack"), tparams, tcfg)

    drafters = []
    for i, dom in enumerate(DOMAINS):
        dp, losses = train_model(dcfg, corpus, dom, args.steps, batch=16,
                                 seq=64, seed=i + 1, device=args.device)
        save_checkpoint(os.path.join(args.out, f"drafter_{dom}.msgpack"), dp,
                        dcfg)
        drafters.append((dcfg, dp, dom))
        print(f"drafter[{dom}] final loss {losses[-1]:.3f}")

    print("\nacceptance matrix (tokens/iteration, drafter x domain):")
    print(f"{'':>8}" + "".join(f"{d:>9}" for d in DOMAINS))
    for dcfg_, dparams, ddom in drafters:
        row = []
        for dom in DOMAINS:
            cos = CoSineConfig(n_drafters=1, draft_len=5,
                               drafters_per_request=1, tree_width=0)
            eng = SpeculativeEngine((tcfg, tparams), [(dcfg_, dparams, ddom)],
                                    cos, strategy="vanilla", max_len=512,
                                    device=args.device)
            pr = [pd for pd in corpus.prompts(10, 16, seed=21)
                  if pd[1] == dom][:2]
            for p, d in pr:
                eng.submit(p, max_new_tokens=24, domain=d)
            st = eng.run()
            iters = sum(r.n_iterations for r in eng.pool.completed)
            row.append(st.total_committed / max(iters, 1))
        print(f"{ddom:>8}" + "".join(f"{v:>9.2f}" for v in row))


if __name__ == "__main__":
    main()
