"""The yardstick's arithmetic on small cases checked by hand."""

import pytest
import torch

from portbench import core, yardstick
from portbench.reference.config import EnvConfig


def test_step_bound_of_an_empty_world_by_hand():
    cfg = EnvConfig(num_worlds=1, init_agents=4, max_agents=4)
    none = torch.zeros(1, 4, dtype=torch.bool)
    # reads: 4 alive bytes + food tables 240 * (4 + 8) + 4 + 16 + the step count 4
    # writes: 4 slots * 113 B + 4 cleared * 220 B + 240 * 4 + 4 + 32 + the step count 4
    assert yardstick.step_bound(none, none, 0, cfg) == (2908 + 2332, 24.0)


def test_raycast_bound_of_two_agents_in_one_place_by_hand():
    cfg = EnvConfig(num_worlds=1, init_agents=2, max_agents=2, num_species=2)
    nbyte, flops = yardstick.raycast_bound(torch.full((1, 2, 2), 10.0), torch.zeros(1, 2),
                                           torch.ones(1, 2, dtype=torch.bool), cfg)
    # 2 ordered pairs, 33 tests each; none passes the cull (tc = 0 < near)
    assert flops == 6 * 2 + 5 * 2 * 33
    assert nbyte == 2 * 17 + 2 * 68 + 4 * 32


def test_bound_s_takes_the_larger_and_percentile_interpolates():
    assert yardstick.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 67e12) == pytest.approx(1.0)
    assert core.percentile([1, 2, 3, 4, 5], 95) == pytest.approx(4.8)
    assert core.percentile([7], 95) == 7
