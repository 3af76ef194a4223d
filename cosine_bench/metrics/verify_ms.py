"""Mean of the verification server's verify tasks that began in the
window (`AsyncTorchBackend.timeline` spans of kind "verify")."""
from cosine_bench.metrics import spans


def read(run):
    v = [s["t1"] - s["t0"] for s in spans(run, "verify")]
    return 1e3 * sum(v) / len(v) if v else None
