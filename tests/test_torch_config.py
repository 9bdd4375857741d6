"""``config.txt`` compatibility: the port's RunConfig and the JAX package's
write the same JSON and read each other's files, both ways."""

import dataclasses
import json

import pytest

from mtad_gat_tpu.config import MTADGATConfig as JaxModelConfig
from mtad_gat_tpu.config import RunConfig as JaxRunConfig
from mtad_gat_tpu.config import lookup_pot_params as jax_lookup
from mtad_gat_tpu_torch.config import (
    GRU_PALLAS_MIN_WINDOW,
    MTADGATConfig,
    PredictConfig,
    RunConfig,
    TrainConfig,
    lookup_pot_params,
)


def test_same_fields_and_defaults():
    import mtad_gat_tpu.config as jc

    for port_cls, jax_cls in ((RunConfig, jc.RunConfig), (MTADGATConfig, jc.MTADGATConfig),
                              (TrainConfig, jc.TrainConfig), (PredictConfig, jc.PredictConfig)):
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_config_txt_round_trip(tmp_path, direction):
    kw = dict(dataset="MSL", lookback=37, bs=64, attention_impl="pallas",
              gru_impl="pallas", compute_dtype="bfloat16", use_mov_av=True,
              level=0.97, feature_edges=[[0, 1], [1, 0]], comment="x")
    writer, reader = (RunConfig, JaxRunConfig) if direction == "port_to_jax" else (
        JaxRunConfig, RunConfig)
    path = tmp_path / "config.txt"
    writer(**kw).save(str(path))
    loaded = reader.load(str(path))
    assert dataclasses.asdict(loaded) == json.loads(path.read_text())
    assert loaded.to_json() == writer(**kw).to_json()
    # the model configs derived from it agree too
    assert dataclasses.asdict(loaded.model_config(38, 38)) == dataclasses.asdict(
        writer(**kw).model_config(38, 38))


def test_old_config_without_gru_impl_pins_xla(tmp_path):
    d = dataclasses.asdict(RunConfig())
    del d["gru_impl"]
    d["an_unknown_key"] = 1
    path = tmp_path / "config.txt"
    path.write_text(json.dumps(d))
    assert RunConfig.load(str(path)).gru_impl == "xla"
    assert JaxRunConfig.load(str(path)).gru_impl == "xla"


@pytest.mark.parametrize("window,impl", [(100, "auto"), (1024, "auto"), (100, "pallas"), (4096, "xla")])
def test_resolved_gru_impl_matches(window, impl):
    """An explicit choice resolves as in the JAX package; "auto" resolves by
    the port's own window, measured on its own hardware (PERF.md), while the
    JAX package keeps its own."""
    got = MTADGATConfig(window_size=window, gru_impl=impl).resolved_gru_impl()
    if impl == "auto":
        assert got == ("pallas" if window >= GRU_PALLAS_MIN_WINDOW else "xla")
    else:
        assert got == JaxModelConfig(window_size=window, gru_impl=impl).resolved_gru_impl()


@pytest.mark.parametrize("offset,want", [(-1, "xla"), (0, "pallas"), (1, "pallas")])
def test_auto_gru_impl_switches_at_the_ports_window(offset, want):
    window = GRU_PALLAS_MIN_WINDOW + offset
    assert MTADGATConfig(window_size=window).resolved_gru_impl() == want
    assert MTADGATConfig(window_size=window, gru_impl="xla").resolved_gru_impl() == "xla"


@pytest.mark.parametrize("kw", [
    dict(attention_impl="flash"), dict(compute_dtype="float16"), dict(gru_impl="cudnn"),
    dict(gru_unroll=0), dict(feature_graph="band:3"), dict(temporal_graph="knn:2"),
    dict(attention_impl="pallas", use_gatv2=False), dict(attention_impl="ring", use_gatv2=False),
    dict(attention_impl="pallas", temporal_graph="band:4"), dict(bias_storage="diag"),
    dict(bias_storage="band"), dict(feature_graph="star"), dict(temporal_graph="band:0"),
])
def test_validation_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError) as jax_err:
        JaxModelConfig(**kw)
    with pytest.raises(ValueError) as port_err:
        MTADGATConfig(**kw)
    assert str(port_err.value).split("(")[0] == str(jax_err.value).split("(")[0]


@pytest.mark.parametrize("args", [("SMD", "1-1", None, None), ("SMD", "3-4", 0.9, None),
                                  ("MSL", "1-1", None, 0.01), ("SMAP", "1-1", None, None)])
def test_lookup_pot_params_matches(args):
    assert lookup_pot_params(*args) == jax_lookup(*args)
