"""The port's config sections against the JAX package's ``config.py``.

Exact: every field of the sections the port copies whole (``faults``,
``deadlines``, ``observability``, and those of earlier slices) and every
``pipeline`` field it carries has the JAX package's name and default, also
under the sections' environment overrides; the port's table of the keys it
drops (``config._DROPPED``) holds the JAX package's defaults. A dropped key
set away from its default is logged once a process (file or override), one
at its default is not, and an unknown key is still an error.
"""
import dataclasses
import json

import pytest

from structured_light_for_3d_model_replication_tpu import config as jconfig
from structured_light_for_3d_model_replication_tpu_torch import config


@pytest.fixture(autouse=True)
def _fresh_log(monkeypatch):
    monkeypatch.setattr(config, "_logged", set())


@pytest.mark.parametrize("env", [{}, {"SL3D_TRACE": "1", "SL3D_NO_DEADLINES": "1",
                                      "SL3D_RUN_BUDGET_S": "30"}])
def test_copied_sections_have_the_jax_defaults(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, jax = config.Config().to_dict(), jconfig.Config().to_dict()
    for section in ("faults", "deadlines", "observability", "projector", "decode",
                    "triangulate", "clean", "merge", "mesh", "checkerboard", "acquire",
                    "coordinator", "serving", "scan_root"):
        assert port[section] == jax[section], section
    for section in ("pipeline", "parallel"):
        assert port[section] == {k: jax[section][k] for k in port[section]}
    assert config.Config().deadlines.enabled is not bool(env)
    assert config.Config().pipeline.run_budget_s == (30.0 if env else 0.0)


def test_the_dropped_table_holds_the_jax_defaults():
    jax = jconfig.Config().to_dict()
    port = config.Config().to_dict()
    for name, dropped in config._DROPPED.items():
        if isinstance(dropped, dict):
            assert dropped == {k: v for k, v in jax[name].items()
                               if k not in port.get(name, {})}, name
        else:
            assert dropped == jax[name]
    # every JAX section and top-level key is carried or dropped
    assert set(jax) == set(port) | set(config._DROPPED)


def test_a_dropped_key_away_from_its_default_is_logged_once(tmp_path, capsys):
    jcfg = jconfig.Config()
    jcfg.parallel.merge_mesh = True
    jcfg.parallel.shard_views = False
    jcfg.pipeline.fused_clean = True   # a carried key: it loads and is not logged
    jcfg.parallel.data_axis = 3
    jcfg.pipeline.max_retries = 5
    jcfg.save(str(tmp_path / "jax.json"))
    for _ in range(2):
        cfg = config.load_config(str(tmp_path / "jax.json"))
    cfg2 = config.load_config(None, {"parallel.model_axis": "2",
                                     "pipeline.ascii_output": "false",
                                     "parallel.merge_mesh": "true"})
    err = capsys.readouterr().err.splitlines()
    assert sorted(err) == sorted([
        "[config] parallel.merge_mesh=True is not ported; the port ignores it "
        "(default False)",
        "[config] parallel.shard_views=False is not ported; the port ignores it "
        "(default True)",
        "[config] parallel.data_axis=3 is not ported; the port ignores it (default 0)",
        "[config] parallel.model_axis=2 is not ported; the port ignores it (default 1)"])
    assert cfg.pipeline.max_retries == 5 and cfg2.pipeline.max_retries == 2
    assert cfg.pipeline.fused_clean is True and cfg2.pipeline.ascii_output is False
    with open(tmp_path / "bad.json", "w") as f:
        json.dump({"pipeline": {"max_retriez": 1}}, f)
    with pytest.raises(ValueError, match="Unknown key"):
        config.load_config(str(tmp_path / "bad.json"))
    with pytest.raises(AttributeError):
        config.load_config(None, {"deadlines.register": "1"})
    assert dataclasses.fields(config.FaultsConfig)[0].name == "spec"


def test_force_bf16_features_is_carried_and_round_trips(tmp_path, capsys):
    """parallel.force_bf16_features loads into the port (no longer dropped,
    so never logged), from a JAX-package file and an override, and the
    ``config`` JSON gives it back where the JAX package's has it."""
    jcfg = jconfig.Config()
    jcfg.parallel.force_bf16_features = True
    jcfg.save(str(tmp_path / "jax.json"))
    cfg = config.load_config(str(tmp_path / "jax.json"))
    assert cfg.parallel.force_bf16_features is True
    assert config.load_config(None, {"parallel.force_bf16_features": "true"}) \
        .parallel.force_bf16_features is True
    assert config.Config().parallel.force_bf16_features is False
    assert "force_bf16_features" not in config._DROPPED["parallel"]
    assert capsys.readouterr().err == ""
    parallel = config.jax_dict(cfg)["parallel"]
    assert parallel == jcfg.to_dict()["parallel"]
    assert list(parallel) == list(jcfg.to_dict()["parallel"])


def test_checkerboard_and_acquire_are_carried_in_the_jax_order(tmp_path, capsys):
    """The calibration target and the capture rig load into the port (no
    longer dropped, so never logged), from a JAX-package file and from
    overrides, and the ``config`` JSON equals the JAX package's, key order
    included."""
    jcfg = jconfig.Config()
    jcfg.checkerboard.rows, jcfg.checkerboard.cols = 6, 9
    jcfg.checkerboard.square_size_mm = 10.0
    jcfg.acquire.simulate = True
    jcfg.acquire.pack_frames = True
    jcfg.acquire.http_port = 0
    jcfg.save(str(tmp_path / "jax.json"))
    cfg = config.load_config(str(tmp_path / "jax.json"))
    assert (cfg.checkerboard.rows, cfg.checkerboard.cols) == (6, 9)
    assert cfg.checkerboard.square_size_mm == 10.0
    assert cfg.acquire.simulate is True and cfg.acquire.pack_frames is True
    assert cfg.acquire.http_port == 0
    over = config.load_config(None, {"acquire.simulate": "true", "checkerboard.rows": "6",
                                     "acquire.settle_ms_scan": "0"})
    assert over.acquire.simulate is True and over.checkerboard.rows == 6
    assert over.acquire.settle_ms_scan == 0
    assert capsys.readouterr().err == ""
    assert "checkerboard" not in config._DROPPED and "acquire" not in config._DROPPED
    assert json.dumps(config.jax_dict(cfg)) == json.dumps(jcfg.to_dict())
    j_over = jconfig.load_config(None, {"acquire.simulate": "true",
                                        "checkerboard.rows": "6",
                                        "acquire.settle_ms_scan": "0"})
    assert json.dumps(config.jax_dict(over)) == json.dumps(j_over.to_dict())


def test_the_coordinator_section_and_merge_incremental_are_carried(tmp_path, capsys):
    """``coordinator`` and ``merge.incremental`` load into the port (no
    longer dropped, so never logged), from a JAX-package file and from
    overrides, and the ``config`` JSON equals the JAX package's, key order
    included; ``serving`` and ``scan_root`` are carried as well."""
    jcfg = jconfig.Config()
    jcfg.coordinator.workers = 3
    jcfg.coordinator.listen = "127.0.0.1:0"
    jcfg.coordinator.secret = "s3"
    jcfg.coordinator.lease_s = 8.0
    jcfg.merge.incremental = True
    jcfg.save(str(tmp_path / "jax.json"))
    cfg = config.load_config(str(tmp_path / "jax.json"))
    assert (cfg.coordinator.workers, cfg.coordinator.listen) == (3, "127.0.0.1:0")
    assert cfg.coordinator.secret == "s3" and cfg.coordinator.lease_s == 8.0
    assert cfg.merge.incremental is True
    over = config.load_config(None, {"coordinator.workers": "2",
                                     "coordinator.heartbeat_s": "1",
                                     "merge.incremental": "true"})
    assert over.coordinator.workers == 2 and over.coordinator.heartbeat_s == 1.0
    assert over.merge.incremental is True
    assert capsys.readouterr().err == ""
    assert "coordinator" not in config._DROPPED and "serving" not in config._DROPPED
    assert "scan_root" not in config._DROPPED
    assert [f.name for f in dataclasses.fields(config.CoordinatorConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.CoordinatorConfig)]
    assert json.dumps(config.jax_dict(cfg)) == json.dumps(jcfg.to_dict())


def test_the_serving_section_and_scan_root_are_carried(tmp_path, capsys):
    """``serving`` and ``scan_root`` load into the port (never logged),
    from a JAX-package file and from overrides, with the JAX package's
    field names in its order, and the ``config`` JSON equals the JAX
    package's."""
    jcfg = jconfig.Config()
    jcfg.serving.ha_enabled = True
    jcfg.serving.fleet_max_workers = 2
    jcfg.serving.auth_rate_limit = 5
    jcfg.serving.clean_steps = "statistical"
    jcfg.scan_root = "/scans"
    jcfg.save(str(tmp_path / "jax.json"))
    cfg = config.load_config(str(tmp_path / "jax.json"))
    assert cfg.serving.ha_enabled is True and cfg.serving.fleet_max_workers == 2
    assert cfg.serving.auth_rate_limit == 5 and cfg.scan_root == "/scans"
    over = config.load_config(None, {"serving.port": "0", "serving.ha_lease_s": "1.5",
                                     "scan_root": "r"})
    assert over.serving.port == 0 and over.serving.ha_lease_s == 1.5
    assert over.scan_root == "r"
    assert capsys.readouterr().err == ""
    assert [f.name for f in dataclasses.fields(config.ServingConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.ServingConfig)]
    assert json.dumps(config.jax_dict(cfg)) == json.dumps(jcfg.to_dict())
    j_over = jconfig.load_config(None, {"serving.port": "0", "serving.ha_lease_s": "1.5",
                                        "scan_root": "r"})
    assert json.dumps(config.jax_dict(over)) == json.dumps(j_over.to_dict())
