"""The overlap A/B benchmark must run on the virtual CPU mesh and report
bitwise-equal schedules."""

import json

from benchmarks.overlap_ab import main


def test_overlap_ab_runs(capsys):
    rc = main(["--n", "256", "--few", "4", "--delta", "12", "--reps", "2"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["bitwise_equal"] is True
    assert rec["devices"] == 8
    assert rec["overlap_us_per_sweep"] > 0
