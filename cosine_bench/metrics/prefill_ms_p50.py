"""Median, by nearest rank, of the verification server's prefill tasks
that began in the window (`AsyncTorchBackend.timeline` spans of kind
"prefill": each ends when the server's stream has finished it)."""
from cosine_bench.metrics import nearest_rank, spans


def read(run):
    v = nearest_rank([s["t1"] - s["t0"] for s in spans(run, "prefill")], 0.5)
    return None if v is None else v * 1e3
