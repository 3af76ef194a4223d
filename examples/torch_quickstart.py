"""Quickstart for the PyTorch port: serve a few requests with CoSine and
with plain autoregressive decoding (`ar`) on a tiny target and two tiny
drafters, and check that both commit the same tokens.

  PYTHONPATH=src python examples/torch_quickstart.py            # on CUDA
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port does not train yet, so the weights are seeded random weights
(`init_params`) in float32 at `tiny_target`/`tiny_drafter` widths:
acceptance is low, but the losslessness check is the same as
`examples/quickstart.py`'s: CoSine's outputs equal AR's, bit for bit.
"""
import argparse

from repro_torch.config import CoSineConfig
from repro_torch.configs.drafters import tiny_drafter, tiny_target
from repro_torch.data.synthetic import DOMAINS, SyntheticCorpus
from repro_torch.models.model import init_params
from repro_torch.serving.engine import SpeculativeEngine

VOCAB = 96


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    corpus = SyntheticCorpus(VOCAB, seed=0, sharpness=60.0, support=6)
    tcfg = tiny_target(VOCAB).with_overrides(dtype="float32")
    dcfg = tiny_drafter(VOCAB).with_overrides(dtype="float32")
    print(f"== seeded weights on {args.device}: {tcfg.name} + 2 x "
          f"{dcfg.name} ==")
    tparams = init_params(tcfg, 0, device=args.device)
    drafters = [(dcfg, init_params(dcfg, i + 1, device=args.device), dom)
                for i, dom in enumerate(DOMAINS[:2])]

    print("== serving 4 requests (piqa/medqa): CoSine vs AR ==")
    prompts = [pd for pd in corpus.prompts(20, 16, seed=3)
               if pd[1] in DOMAINS[:2]][:4]
    results = {}
    for strategy in ("ar", "cosine"):
        cos = CoSineConfig(n_drafters=2, draft_len=5, drafters_per_request=2,
                           tree_width=2)
        eng = SpeculativeEngine((tcfg, tparams), drafters, cos,
                                strategy=strategy, max_len=512,
                                device=args.device)
        for p, dom in prompts:
            eng.submit(p, max_new_tokens=32, domain=dom)
        stats = eng.run()
        results[strategy] = (stats, {tuple(r.prompt.tolist()): r.generated
                                     for r in eng.pool.completed})
        print(f"  {strategy:7s}: {stats.total_committed} tokens in "
              f"{stats.sim_ms:.0f} sim-ms "
              f"({stats.throughput_tps:.1f} tok/s, "
              f"{stats.mean_acceptance:.2f} tokens/iteration)")

    if results["ar"][1] != results["cosine"][1]:
        raise SystemExit("losslessness violated: CoSine committed other "
                         "tokens than AR")
    sp = results["cosine"][0].throughput_tps / results["ar"][0].throughput_tps
    print(f"\nCoSine speedup over AR (simulated clock): {sp:.2f}x — "
          f"outputs bit-identical ✓")


if __name__ == "__main__":
    main()
