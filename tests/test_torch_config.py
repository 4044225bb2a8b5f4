"""The port's config copy equals the JAX package's, field by field."""

import dataclasses

import pytest

import madrona_bots_tpu.config as jcfg
import madrona_bots_tpu_torch.config as tcfg

DERIVED = ["world_lim_x", "world_lim_y", "num_chunks", "num_forward_rays",
           "num_backward_rays", "max_range", "respawn_floor", "obs_dim",
           "agents_per_species"]


def test_env_config_fields_and_defaults_match():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jcfg.EnvConfig)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(tcfg.EnvConfig)]
    assert jf == tf
    assert tcfg.EnvConfig.__dataclass_params__.frozen


@pytest.mark.parametrize("kw", [
    {},
    dict(num_worlds=8192, init_agents=32, max_agents=128),
    dict(num_worlds=3, init_agents=8, max_agents=16, num_chunks_x=5,
         num_chunks_y=3, total_allowed_food=11),
    dict(num_worlds=2, init_agents=12, max_agents=24, num_species=2),
])
def test_derived_properties_match(kw):
    j, t = jcfg.EnvConfig(**kw), tcfg.EnvConfig(**kw)
    for name in DERIVED:
        assert getattr(j, name) == getattr(t, name), name


@pytest.mark.parametrize("kw", [dict(sensor_size=30), dict(init_agents=200),
                                dict(init_agents=10), dict(max_agents=130)])
def test_invalid_configs_rejected_alike(kw):
    with pytest.raises(AssertionError):
        jcfg.EnvConfig(**kw)
    with pytest.raises(AssertionError):
        tcfg.EnvConfig(**kw)


def test_constants_match():
    assert {m.name: int(m) for m in jcfg.RewardSetting} == \
        {m.name: int(m) for m in tcfg.RewardSetting}
    for name in ["ACTION_FORWARD", "ACTION_BACKWARD", "ACTION_ROTATE_LEFT",
                 "ACTION_ROTATE_RIGHT", "ACTION_SHOOT", "ACTION_BREED",
                 "NUM_ACTIONS", "SALT_WORLD", "SALT_INIT", "SALT_FOOD",
                 "SALT_RESPAWN"]:
        assert getattr(jcfg, name) == getattr(tcfg, name), name
