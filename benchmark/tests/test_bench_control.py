"""The control: the reference put in the program's place in bfloat16, the
precision next below the configurations' float32 that changes the
arithmetic (TF32 never engages at the solver's shapes).  It has to read
``correct`` false against each configuration's limits, where the float32
reference reads true.  On the card the same at the cells' own sizes is
``readings.py --control``."""

import pytest

from harness import check, manifest, traffic

import run


@pytest.mark.parametrize("cell", ["bridge_p4.replan", "cross_u64.replan"])
def test_the_control_reads_incorrect(cell):
    c = manifest.cell(cell, unlisted=True)
    run.rehearsal(c)
    config = c.config
    request = traffic.make_pool(config, c.traffic, 2**31 + 21)[0]
    ref = check.Reference(config, "cpu")
    want = ref.solve(request, "float64")
    limits = config["check"]["limits"]
    sound, _ = check.judge(ref.numbers(ref.solve(request, "float32"), want, request.cloud), limits)
    control, checks = check.judge(ref.numbers(ref.solve(request, "bfloat16"), want,
                                              request.cloud), limits)
    assert sound and not control, checks


@pytest.mark.cuda
def test_the_control_reads_incorrect_on_the_card(card):
    """One bridge request at the cell's own size, on the card."""
    c = manifest.cell("bridge_p4.replan")
    request = traffic.make_pool(c.config, c.traffic, 2**31 + 22)[0]
    ref = check.Reference(c.config, card)
    want = ref.solve(request, "float64")
    control, checks = check.judge(ref.numbers(ref.solve(request, "bfloat16"), want,
                                              request.cloud), c.config["check"]["limits"])
    assert not control, checks
