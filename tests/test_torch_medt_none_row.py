"""``chip_smoke.py``'s decision of the served MedT "none" row (CPU).

``medt_faults`` reads each forward of a served MedT model four ways (rel L2
to the plain path, mask agreement, distance to f32 compute over the plain
path's, every K6 launch against K6's plain version). For the 128px names
the first three are decided on the medians over ``MEDT_INPUTS`` seeded
inputs (``medt_bars``, through ``medians_failed``) and the "none" row (no
fault planted) on every K6 launch, with the same limits; ``gated`` and
every planted-fault row are decided on the forward's own readings. These
decisions are plain Python, held here.
"""

import pytest

import chip_smoke as cs

SMALL = cs.MEDT_REL_L2["small"]
# one 128px input whose masks fall under the bar while every K6 launch
# agrees with its plain version (one K6 build read 0.98914 on `medt` here)
UNLUCKY = dict(rel_l2=6.1e-2, mask_agreement=0.98914, f32_ratio=0.97, launch_reading_max=2.6e-6)
MEDIANS = dict(rel=4.6e-2, kp=0.99155, ratio=0.99, kf=0.99220, pf=0.99182)


def test_none_row_passes_with_one_input_under_the_bar():
    assert cs.failed_checks(UNLUCKY, SMALL) == ["mask_agreement"]
    assert cs.medians_failed(MEDIANS, SMALL) == []
    assert cs.none_row_failed(UNLUCKY, SMALL, on_medians=True) == []


@pytest.mark.parametrize("key,value,check", [
    ("rel", 1.01e-1, "rel_l2"),
    ("kp", 0.98999, "mask_agreement"),
    ("ratio", 1.2501, "f32_ratio"),
    ("kf", 0.98681, "f32_agreement"),
])
def test_medians_fail_over_their_limit(key, value, check):
    assert cs.medians_failed(dict(MEDIANS, **{key: value}), SMALL) == [check]


@pytest.mark.parametrize("reading", [1.001e-3, 5e-2, float("nan")])
def test_none_row_fails_on_a_launch_over_its_limit(reading):
    r = dict(UNLUCKY, launch_reading_max=reading)
    assert cs.none_row_failed(r, SMALL, on_medians=True) == ["launch_reading"]


def test_none_row_limits_are_unchanged():
    assert (cs.MEDT_AGREE, cs.MEDT_F32_RATIO, cs.K6_SHARE, SMALL) == (0.99, 1.25, 1e-3, 1e-1)
    assert cs.MEDT_F32_AGREE_SLACK == 0.005
    edge = dict(rel_l2=SMALL, mask_agreement=cs.MEDT_AGREE, f32_ratio=cs.MEDT_F32_RATIO,
                launch_reading_max=cs.K6_SHARE)
    assert cs.failed_checks(edge, SMALL) == []
    assert cs.none_row_failed(edge, SMALL, on_medians=True) == []
    assert cs.medians_failed(dict(rel=SMALL, kp=cs.MEDT_AGREE, ratio=cs.MEDT_F32_RATIO,
                                  kf=0.98, pf=0.985), SMALL) == []


def test_gated_none_row_is_decided_on_its_own_forward():
    """gated has no medians: its one B=8/256px input decides, as before."""
    limit = cs.MEDT_REL_L2["gated"]
    assert cs.none_row_failed(UNLUCKY, limit, on_medians=False) == ["rel_l2", "mask_agreement"]
    good = dict(rel_l2=6.8e-3, mask_agreement=0.99982, f32_ratio=0.9, launch_reading_max=3e-6)
    assert cs.none_row_failed(good, limit, on_medians=False) == []


@pytest.mark.parametrize("fault", [
    # q and k swapped in medt: the launch readings reject it
    dict(rel_l2=3.1e-2, mask_agreement=0.995, f32_ratio=1.0, launch_reading_max=1.9),
    # a fault that moves the logits but not the launches' largest reading
    dict(rel_l2=0.4, mask_agreement=0.93, f32_ratio=3.0, launch_reading_max=5e-4),
])
def test_fault_rows_are_decided_on_the_forward_as_before(fault):
    """A planted-fault row fails on its own forward's readings; good medians
    do not enter its decision."""
    assert cs.failed_checks(fault, SMALL)
