"""`tools/ssm_streams.py`'s report: the first differing token of two
runs' streams and both candidates' logits under each run's scan, and
the rows of a scan call that no padding row shares."""
import importlib.util
from pathlib import Path

import torch

_spec = importlib.util.spec_from_file_location(
    "ssm_streams",
    Path(__file__).resolve().parents[1] / "tools" / "ssm_streams.py")
ssm_streams = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ssm_streams)


def _top(*pairs):
    return [list(p) for p in pairs]


def test_report_gives_first_divergence_and_both_logits():
    """Run a commits [5, 6, 7], run b [5, 6, 9]: the report names token
    2, both candidates, and their logits under each run's teacher-forced
    prefix (b's own stream, a's stream for a); a candidate outside a
    run's top list reads None; equal streams give no row."""
    pos = [_top((5, 2.0), (1, 1.0)), _top((6, 2.0), (2, 1.0))]
    tf_a = {"a": [pos + [_top((7, 3.0), (9, 2.99))]]}
    tf_b = {"a": [pos + [_top((9, 3.01), (7, 3.0))]],
            "b": [pos + [_top((9, 3.01), (4, 1.0))]]}
    results = {
        "a": {"phases": {"E": {"streams": [[5, 6, 7]], "teacher_forced": tf_a},
                         "F": {"streams": [[1]], "teacher_forced": {}}}},
        "b": {"phases": {"E": {"streams": [[5, 6, 9]], "teacher_forced": tf_b},
                         "F": {"streams": [[1]], "teacher_forced": {}}}},
    }
    rows = ssm_streams.report(results)["divergences"]
    assert len(rows) == 1
    d = rows[0]
    assert (d["phase"], d["request"], d["token"], d["a"], d["b"]) == (
        "E", 0, 2, 7, 9)
    assert abs(d["under"]["a"]["gap_a_minus_b"] - 0.01) < 1e-9
    assert abs(d["under"]["b"]["gap_a_minus_b"] + 0.01) < 1e-9
    assert d["under"]["b"]["top1"] == 9


def test_real_rows_leave_out_shared_slots():
    """Rows whose slot another row shares (padding on the scratch slot)
    are left out of the comparison; without slot indices every row
    counts."""
    rows, slots = ssm_streams._real_rows(
        torch.tensor([3, 0, 7, 7], dtype=torch.int32), 4)
    assert (rows, slots) == ([0, 1], [3, 0])
    assert ssm_streams._real_rows(None, 3) == ([0, 1, 2], [0, 1, 2])
