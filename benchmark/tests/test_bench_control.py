"""The controls of the cells' correctness checks, at a size a test run can
hold: the plain reference one precision below the configuration's, put in
the program's place, comes out not correct, and reads beyond the limits
that it set. On the card it runs at the cells' own sizes through
`benchmark/control.py --control-seeds`; PERF.md gives those readings."""

import copy

from benchmark.tests.conftest import TINY


def test_completion_control(tiny_run):
    """The networks' products in float8, FPS and the solver step in
    bfloat16."""
    tiny = copy.deepcopy(TINY["diff.complete"])
    tiny["env"] = {"LIDIFF_COMPUTE_DTYPE": "bfloat16"}
    out = tiny_run("diff.complete", overrides=tiny)
    assert out.correct, out.checks
    ctl = tiny_run("diff.complete", overrides=tiny, control="lower")
    assert not ctl.correct
    read = {n: (v, lim) for n, v, lim in ctl.checks}
    for name in ("fps_picks_differ", "bank_gap", "eps_gap", "solver_gap",
                 "refine_gap"):
        assert read[name][0] > read[name][1], (name, read[name])


def test_training_control(tiny_run):
    """The refiner's training steps from operands in float8."""
    out = tiny_run("refine.train")
    assert out.correct, out.checks
    ctl = tiny_run("refine.train", control="lower")
    assert not ctl.correct
    read = {n: (v, lim) for n, v, lim in ctl.checks}
    for name in ("grad_gap", "grad_median_gap"):
        assert read[name][0] > read[name][1], (name, read[name])
