"""Committed tokens per request per iteration: the engine's committed
tokens over the sum of its cohorts' sizes, over the iterations of the
window (`IterationRecord.committed` and `.batch`, the counters
`serve.committed_tokens` and `serve.batch_size`)."""
from cosine_bench.metrics import records


def read(run):
    recs = records(run)
    batch = sum(r["batch"] for r in recs)
    return sum(r["committed"] for r in recs) / batch if batch else None
