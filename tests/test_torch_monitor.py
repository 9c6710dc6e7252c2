"""The monitor of ``deepspeed_tpu_torch`` (``monitor/monitor.py``) against
the JAX package: the monitor cases of ``tests/unit/test_schedules_monitor.py``
(the CSV backend, ``MonitorMaster``, the flush contract), the training
engine's ``Train/Samples/*`` events, and the serving engine's
``Serving/*`` events.

Both engines write through their own ``csvMonitor`` into a directory each;
the files are read back and compared.  Series names, steps and row counts
are equal; the values are equal where they depend on the data alone (the
learning rate bitwise, the training loss to ``LOSS_RTOL`` in fp32, the
serving counters exactly), and the wall-clock series (``decode_tok_s``,
``lock_wait_*``) are only required to be finite.
"""

import csv
import math
import os

import numpy as np
import pytest
import torch

from torch_frontend_common import drain_all, engines, workload

LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read_csvs(root):
    """``{series file stem: [(step, value), ...]}`` under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".csv"):
                with open(os.path.join(dirpath, f)) as fh:
                    rows = list(csv.reader(fh))
                out[f[:-4]] = [(int(s), float(v)) for s, v in rows[1:]]
    return out


def _monitor_config(mod, path):
    return mod.MonitorConfig(
        tensorboard=mod.TensorBoardConfig(enabled=False),
        wandb=mod.WandbConfig(enabled=False),
        csv_monitor=mod.CSVConfig(enabled=True, output_path=str(path),
                                  job_name="job"))


def test_csv_monitor_and_master_match_jax(tmp_path):
    from deepspeed_tpu.monitor import monitor as jmon
    from deepspeed_tpu.runtime import config as jconf
    from deepspeed_tpu_torch.monitor import monitor as pmon
    from deepspeed_tpu_torch.runtime import config as pconf
    events = [[("Train/loss", 1.5, 10), ("Train/lr", 0.1, 10)],
              [("Train/loss", 1.2, 20)]]
    for mon, conf, d in ((jmon, jconf, "jax"), (pmon, pconf, "port")):
        master = mon.MonitorMaster(_monitor_config(conf, tmp_path / d))
        assert master.enabled and len(master.backends) == 1
        for batch in events:
            master.write_events(batch)
        master.flush()
        master.close()
    want = _read_csvs(tmp_path / "jax")
    assert _read_csvs(tmp_path / "port") == want
    assert want["Train_loss"] == [(10, 1.5), (20, 1.2)]


def test_csv_monitor_flush_modes_and_context_manager(tmp_path):
    """Per-batch durability by default; ``batch_flush=False`` holds the row
    until ``flush()`` / ``close()``; the context manager closes."""
    from deepspeed_tpu_torch.monitor.monitor import csvMonitor
    from deepspeed_tpu_torch.runtime.config import CSVConfig
    cfg = CSVConfig(enabled=True, output_path=str(tmp_path), job_name="job")
    path = os.path.join(str(tmp_path), "job", "Serving_tok_s.csv")
    mon0 = csvMonitor(cfg)
    mon0.write_events([("Serving/tok_s", 1.75, 0)])
    assert "1.75" in open(path).read()
    mon0.close()
    mon = csvMonitor(cfg, batch_flush=False)
    mon.write_events([("Serving/tok_s", 3.25, 1)])
    assert "3.25" not in open(path).read()
    mon.flush()
    assert "3.25" in open(path).read()
    mon.write_events([("Serving/tok_s", 7.5, 2)])
    mon.close()
    assert "7.5" in open(path).read() and not mon.filehandles
    with csvMonitor(cfg, batch_flush=False) as mon2:
        mon2.write_events([("Serving/tok_s", 9.125, 3)])
    assert "9.125" in open(path).read()


def test_train_samples_events_match_jax(tmp_path):
    """``Train/Samples/lr`` and ``Train/Samples/train_loss`` every
    ``steps_per_print`` steps at ``global_samples``, from the JAX engine
    and the port's on the same weights and batches."""
    import jax
    import deepspeed_tpu
    import deepspeed_tpu_torch
    from deepspeed_tpu.parallel.topology import (initialize_topology,
                                                 reset_topology)
    from deepspeed_tpu_torch.models import transformer as pt
    from test_torch_train_parity import (CFG, ENGINE_CONFIG, B, S,
                                         random_tree)
    from deepspeed_tpu.models import transformer as jt
    jmodel = jt.Transformer(jt.TransformerConfig(**CFG))
    tree = random_tree(jmodel)
    rng = np.random.default_rng(17)
    batches = [{"input_ids": rng.integers(0, 97, (2, B, S)).astype(np.int32)}
               for _ in range(4)]

    def config(d):
        return dict(ENGINE_CONFIG, steps_per_print=2, csv_monitor={
            "enabled": True, "output_path": str(tmp_path / d),
            "job_name": "job"})

    topo = initialize_topology(dp=1, devices=jax.devices()[:1])
    try:
        jeng, *_ = deepspeed_tpu.initialize(
            model=jmodel, model_parameters=tree, config=config("jax"),
            topology=topo)
        for b in batches:
            jeng.train_batch(batch=b)
        jeng.monitor.close()
    finally:
        reset_topology()
    model = pt.Transformer(pt.TransformerConfig(**dict(CFG, remat=False)))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=tree, config=config("port"),
        device="cpu")
    for b in batches:
        eng.train_batch(batch=b)
    eng.monitor.close()
    want, got = _read_csvs(tmp_path / "jax"), _read_csvs(tmp_path / "port")
    assert sorted(got) == sorted(want) == ["Train_Samples_lr",
                                           "Train_Samples_train_loss"]
    assert [s for s, _ in got["Train_Samples_lr"]] == [8, 16]
    assert got["Train_Samples_lr"] == want["Train_Samples_lr"]
    assert [s for s, _ in got["Train_Samples_train_loss"]] \
        == [s for s, _ in want["Train_Samples_train_loss"]]
    np.testing.assert_allclose(
        [v for _, v in got["Train_Samples_train_loss"]],
        [v for _, v in want["Train_Samples_train_loss"]], rtol=LOSS_RTOL)


# the Serving/* series that depend on the wall clock
WALL_CLOCK = {"Serving_decode_tok_s", "Serving_lock_wait_scheduler_s",
              "Serving_lock_wait_handler_s"}


@pytest.mark.parametrize("over", [{}, dict(paged=True, page_size=16,
                                           fairness_tokens_per_s=1e6)],
                         ids=["lanes", "pool_fairness"])
def test_serving_events_match_jax(tmp_path, over):
    """One ``Serving/*`` row per series per scheduler iteration, at the
    iteration: the same series, steps and counter values from both
    engines for the same requests; the monitor is flushed at close."""
    from deepspeed_tpu.monitor import monitor as jmon
    from deepspeed_tpu.runtime import config as jconf
    from deepspeed_tpu_torch.monitor import monitor as pmon
    from deepspeed_tpu_torch.runtime import config as pconf
    jeng, eng = engines()
    prompts, news = workload(3, 6)
    outs = []
    for e, mon, conf, d in ((jeng, jmon, jconf, "jax"),
                            (eng, pmon, pconf, "port")):
        cfg = _monitor_config(conf, tmp_path / d).csv_monitor
        monitor = mon.csvMonitor(cfg, batch_flush=False)
        outs.append(drain_all(e.serve(monitor=monitor, **over), prompts,
                              news))
        monitor.close()
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(g, w)
    want, got = _read_csvs(tmp_path / "jax"), _read_csvs(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert "Serving_completed" in got and got["Serving_completed"][-1][1] \
        == len(prompts)
    if over:
        assert {"Serving_fairness_rejected", "Serving_page_pool_util",
                "Serving_prefix_hit_rate"} <= set(got)
    for name, rows in want.items():
        assert [s for s, _ in got[name]] == [s for s, _ in rows], name
        if name in WALL_CLOCK:
            assert all(math.isfinite(v) for _, v in got[name]), name
        else:
            assert got[name] == rows, name
