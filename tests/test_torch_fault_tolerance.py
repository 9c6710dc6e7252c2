"""The port's fault tolerance on its training engine (the engine scenarios
of ``tests/unit/test_fault_tolerance.py``, on a 1-layer OPT on the CPU):
crash-atomic checkpoints, verified walk-back, retries, retention,
``run_resilient`` (resume, SIGTERM preemption, the hang watchdog,
transient step faults, ``max_resumes``), the ``ckpt_cli`` tool, the
offline reader, and the kill-and-resume proof: a torch-only subprocess
driver (``torch_fault_driver.py``) killed with ``os._exit`` at each of
the six ``ckpt.*`` seams and relaunched gives, merged, bitwise the
uninterrupted loss trajectory.  The card tests (``cuda`` marker) check
that a save and a load on the device land every tensor on ``cuda`` and
that the asynchronous writer publishes its metadata after the arrays.

This file imports no JAX: on the card, run it with
``python -m pytest --noconftest -m cuda tests/test_torch_fault_tolerance.py``.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

import torch_fault_driver as drv
from deepspeed_tpu_torch.runtime.fault import ckpt_cli, inject
from deepspeed_tpu_torch.runtime.fault.manifest import (
    CheckpointCorrupt, list_tags, newest_valid_tag, read_manifest,
    verify_manifest)
from deepspeed_tpu_torch.runtime.fault.retry import backoff_delay, retry_call
from deepspeed_tpu_torch.runtime.fault.supervisor import (
    elastic_resume_config, run_resilient)

DRIVER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_fault_driver.py")


@pytest.fixture(autouse=True)
def _disarm_injection():
    inject.reset_injection()
    yield
    inject.reset_injection()


make_engine = drv.make_engine


def train_steps(engine, n):
    return [drv.step_fn(engine) for _ in range(n)]


def reference_losses(n):
    return train_steps(make_engine(), n)


def largest_array_file(tag_dir):
    target, size = None, -1
    for dirpath, _d, files in os.walk(os.path.join(tag_dir, "state",
                                                   "arrays")):
        for name in files:
            p = os.path.join(dirpath, name)
            if os.path.getsize(p) > size:
                target, size = p, os.path.getsize(p)
    return target, size


def flip_middle(path, size, data=b"\xde\xad\xbe\xef"):
    with open(path, "r+b") as f:
        f.seek(size // 2)
        f.write(data)


# --------------------------------------------------------------------- #
# Retry policy
# --------------------------------------------------------------------- #
def test_backoff_delay_capped_and_jittered():
    assert backoff_delay(1, base=1.0, jitter=0.0) == 1.0
    assert backoff_delay(4, base=1.0, max_delay=5.0, jitter=0.0) == 5.0
    d = backoff_delay(2, base=1.0, jitter=0.5)
    assert 2.0 <= d <= 3.0
    assert d == backoff_delay(2, base=1.0, jitter=0.5)   # deterministic


def test_retry_call_bounded_and_permanent_errors_not_retried():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise IOError("transient")
        return "ok"

    assert retry_call(flaky, retries=3, base=0.0, jitter=0.0) == "ok"
    assert len(calls) == 3
    calls.clear()
    with pytest.raises(IOError):
        retry_call(flaky, retries=1, base=0.0, jitter=0.0)
    assert len(calls) == 2            # 1 call + 1 retry, then give up

    def missing():
        calls.append(1)
        raise FileNotFoundError("no such file")

    calls.clear()
    with pytest.raises(FileNotFoundError):
        retry_call(missing, retries=3, base=0.0, jitter=0.0)
    assert len(calls) == 1, "permanent errors must not be retried"


# --------------------------------------------------------------------- #
# The engine's checkpoint protocol
# --------------------------------------------------------------------- #
def test_atomic_save_layout_and_latest(tmp_path):
    engine = make_engine()
    train_steps(engine, 2)
    engine.save_checkpoint(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["global_step2", "latest"]
    assert (tmp_path / "latest").read_text() == "global_step2"
    for dirpath, dirnames, filenames in os.walk(tmp_path):
        for n in dirnames + filenames:
            assert ".tmp" not in n and ".old." not in n, n
    tag = tmp_path / "global_step2"
    assert verify_manifest(str(tag)) == []
    manifest = read_manifest(str(tag))
    assert manifest["fingerprint"]["device_type"] == "cpu"
    assert manifest["step"] == {"global_steps": 2, "global_samples": 4,
                                "micro_steps": 2}
    assert sorted(os.listdir(tag / "state")) == ["arrays", "meta.pkl"]
    assert sorted(os.listdir(tag / "state" / "arrays")) == [
        "index.json", "loss_scaler", "module", "optimizer"]
    one = torch.load(tag / "state" / "arrays" / "optimizer" / "exp_avg" /
                     "0.pt", weights_only=True)
    assert torch.equal(one, engine._opt_state.exp_avg[0])


@pytest.mark.parametrize("fault", [False, True], ids=["plain", "fault"])
def test_load_missing_arrays_is_clear_error(fault, tmp_path):
    """A tag without its arrays is ``CheckpointCorrupt`` (not an OSError,
    which the retry policy treats as transient); with ``fault`` on and
    no other tag, auto-resume finds no valid checkpoint."""
    engine = make_engine(enabled=fault)
    train_steps(engine, 1)
    engine.save_checkpoint(str(tmp_path))
    shutil.rmtree(tmp_path / "global_step1" / "state" / "arrays")
    fresh = make_engine(enabled=fault, verify_on_load=False)
    with pytest.raises((CheckpointCorrupt, RuntimeError),
                       match="arrays" if not fault else "no valid"):
        fresh.load_checkpoint(str(tmp_path))
    with pytest.raises(CheckpointCorrupt, match="arrays"):
        fresh.load_checkpoint(str(tmp_path), tag="global_step1")


def test_reserved_tag_names_rejected(tmp_path):
    engine = make_engine()
    train_steps(engine, 1)
    for tag in ("run1.tmp", "v1.old.2"):
        with pytest.raises(ValueError, match="staging namespace"):
            engine.save_checkpoint(str(tmp_path), tag=tag)
    assert not os.path.exists(tmp_path / "latest")


def test_save_latest_false_tags_do_not_hijack_resume(tmp_path):
    engine = make_engine()
    train_steps(engine, 2)
    engine.save_checkpoint(str(tmp_path))                      # step 2
    train_steps(engine, 2)
    engine.save_checkpoint(str(tmp_path), tag="debug_dump",
                           save_latest=False)                  # step 4
    assert (tmp_path / "latest").read_text() == "global_step2"
    e2 = make_engine()
    e2.load_checkpoint(str(tmp_path))
    assert e2.global_steps == 2
    e3 = make_engine()
    e3.load_checkpoint(str(tmp_path), tag="debug_dump")
    assert e3.global_steps == 4


def test_side_tags_only_dir_is_fresh_start(tmp_path):
    engine = make_engine()
    train_steps(engine, 2)
    engine.save_checkpoint(str(tmp_path), tag="debug_only",
                           save_latest=False)
    e2 = make_engine()
    assert e2.load_checkpoint(str(tmp_path)) == (None, {})
    status, info = run_resilient(e2, drv.step_fn, str(tmp_path),
                                 max_steps=2)
    assert status == "done" and e2.global_steps == 2


def test_corrupt_and_partial_tags_walk_back_on_load(tmp_path):
    engine = make_engine()
    train_steps(engine, 2)
    engine.save_checkpoint(str(tmp_path))
    w2 = engine.params[0].clone()
    train_steps(engine, 2)
    engine.save_checkpoint(str(tmp_path))
    target, size = largest_array_file(str(tmp_path / "global_step4"))
    flip_middle(target, size)                  # size-preserving bit rot
    e2 = make_engine()
    e2.load_checkpoint(str(tmp_path))
    assert e2.global_steps == 2, "load must walk back to global_step2"
    assert torch.equal(e2.params[0], w2)
    # gut the older tag too: no valid tag at all
    shutil.rmtree(tmp_path / "global_step2" / "state" / "arrays")
    with pytest.raises(RuntimeError, match="no valid checkpoint"):
        make_engine().load_checkpoint(str(tmp_path))


def test_explicit_tag_failure_raises_not_walks_back(tmp_path):
    engine = make_engine()
    train_steps(engine, 2)
    engine.save_checkpoint(str(tmp_path))
    train_steps(engine, 2)
    engine.save_checkpoint(str(tmp_path))
    target, size = largest_array_file(str(tmp_path / "global_step4"))
    flip_middle(target, size, b"\xbe\xef")
    e2 = make_engine()
    with pytest.raises(CheckpointCorrupt, match="global_step4"):
        e2.load_checkpoint(str(tmp_path), tag="global_step4")
    e2.load_checkpoint(str(tmp_path))          # auto-resume walks back
    assert e2.global_steps == 2


def test_corrupt_shard_seam_is_caught_on_load(tmp_path):
    """The ``corrupt`` action at ``ckpt.corrupt_shard`` flips bytes after
    the manifest is written: the tag publishes, and the next load's
    verification rejects it."""
    engine = make_engine()
    train_steps(engine, 1)
    engine.save_checkpoint(str(tmp_path))
    train_steps(engine, 1)
    inject.configure_injection({"point": "ckpt.corrupt_shard",
                                "action": "corrupt"})
    engine.save_checkpoint(str(tmp_path))
    assert verify_manifest(str(tmp_path / "global_step2"))
    e2 = make_engine()
    e2.load_checkpoint(str(tmp_path))
    assert e2.global_steps == 1


def test_transient_save_ioerror_retries(tmp_path):
    engine = make_engine()
    train_steps(engine, 1)
    specs = inject.configure_injection(
        {"point": "ckpt.save_io", "action": "raise", "times": 2})
    assert engine.save_checkpoint(str(tmp_path)) is True
    assert specs[0].fired == 2, "save must have retried through 2 faults"
    assert verify_manifest(str(tmp_path / "global_step1")) == []


def test_transient_load_ioerror_retries_same_tag(tmp_path, monkeypatch):
    """A transient read error retries the same tag before any walk-back:
    the newest tag loads, not the one before it."""
    engine = make_engine()
    for _ in range(2):
        train_steps(engine, 1)
        engine.save_checkpoint(str(tmp_path))
    e2 = make_engine()
    real, failures = e2.checkpoint_engine.load, []

    def flaky(*args, **kwargs):
        if len(failures) < 2:
            failures.append(1)
            raise OSError("EIO: stale file handle")
        return real(*args, **kwargs)

    monkeypatch.setattr(e2.checkpoint_engine, "load", flaky)
    e2.load_checkpoint(str(tmp_path))
    assert len(failures) == 2 and e2.global_steps == 2


def test_keep_last_n_retention_and_orphan_gc(tmp_path):
    engine = make_engine(keep_last_n=2)
    (tmp_path / "global_step99.tmp").mkdir(parents=True)  # stale orphan
    for _ in range(4):
        train_steps(engine, 1)
        engine.save_checkpoint(str(tmp_path))
    assert list_tags(str(tmp_path)) == ["global_step4", "global_step3"]
    assert not (tmp_path / "global_step99.tmp").exists()
    assert (tmp_path / "latest").read_text() == "global_step4"


def test_nebula_engine_roundtrip_and_strict_knob(tmp_path):
    """``nebula.enabled`` selects the asynchronous writer: the tag it
    leaves loads bitwise; ``load_module_strict=False`` loads the
    intersection of a tag saved without one tensor."""
    engine = make_engine()
    engine._config.nebula_config.enabled = True
    from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine \
        import NebulaCheckpointEngine
    engine.checkpoint_engine = NebulaCheckpointEngine()
    train_steps(engine, 2)
    engine.save_checkpoint(str(tmp_path))
    e2 = make_engine()
    e2.load_checkpoint(str(tmp_path))
    for a, b in zip(e2.params, engine.params):
        assert torch.equal(a, b)
    os.remove(tmp_path / "global_step2" / "state" / "arrays" / "module" /
              "final_norm.bias.pt")
    idx = tmp_path / "global_step2" / "state" / "arrays" / "index.json"
    idx.write_text(idx.read_text().replace(
        '{"path": "module/final_norm.bias", "shape": [32], '
        '"dtype": "float32"}, ', ""))
    e3 = make_engine(verify_on_load=False)
    with pytest.raises(RuntimeError, match="no valid checkpoint"):
        e3.load_checkpoint(str(tmp_path))
    e3.load_checkpoint(str(tmp_path), tag="global_step2",
                       load_module_strict=False)
    assert torch.equal(e3.module.final_norm.weight,
                       engine.module.final_norm.weight)
    assert not torch.equal(e3.module.final_norm.bias,
                           engine.module.final_norm.bias)


def test_meta_write_is_atomic_and_async_meta_lands_at_commit(tmp_path):
    from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine \
        import NebulaCheckpointEngine, TorchCheckpointEngine
    eng = TorchCheckpointEngine()
    eng.save(None, {"k": 1}, str(tmp_path / "sync"))
    assert os.listdir(tmp_path / "sync") == ["meta.pkl"]
    neb = NebulaCheckpointEngine()
    path = str(tmp_path / "state")
    neb.save({"module": {"w": torch.arange(8.0)}}, {"global_steps": 5}, path)
    neb._writer.join()            # the arrays are written, not committed
    assert not os.path.exists(os.path.join(path, "meta.pkl"))
    neb.commit("tag")
    assert os.path.exists(os.path.join(path, "meta.pkl"))
    arrays, meta = neb.load(path)
    assert meta["global_steps"] == 5
    assert torch.equal(arrays["module"]["w"], torch.arange(8.0))


def test_deepspeed_checkpoint_reader(tmp_path):
    from deepspeed_tpu_torch.checkpoint import DeepSpeedCheckpoint
    engine = make_engine()
    train_steps(engine, 3)
    engine.save_checkpoint(str(tmp_path))
    engine.save_checkpoint(str(tmp_path), tag="side", save_latest=False)
    ck = DeepSpeedCheckpoint(str(tmp_path))
    assert ck.tag == "global_step3" and ck.get_tags() == ["global_step3",
                                                          "side"]
    assert ck.global_steps == 3 and ck.ds_config["seed"] == 7
    sd = engine.module.state_dict()
    assert ck.parameter_names() == sorted(sd)
    assert ck.parameter_shapes() == {k: tuple(v.shape)
                                     for k, v in sd.items()}
    assert ck.num_parameters() == sum(v.numel() for v in sd.values())
    for k, v in ck.flat_parameters().items():
        assert torch.equal(v, sd[k])
    opt = ck.optimizer_state()
    assert sorted(opt) == ["exp_avg", "exp_avg_sq"]
    for got, want in zip(opt["exp_avg_sq"], engine._opt_state.exp_avg_sq):
        assert torch.equal(got, want)


# --------------------------------------------------------------------- #
# The supervisor
# --------------------------------------------------------------------- #
def test_supervisor_surfaces_permanent_step_errors(tmp_path):
    engine = make_engine()
    train_steps(engine, 1)

    def broken_step(engine):
        raise FileNotFoundError("/nonexistent/data.bin")

    with pytest.raises(FileNotFoundError):
        run_resilient(engine, broken_step, str(tmp_path), max_steps=3)


def test_run_resilient_plain_completion_and_resume(tmp_path):
    engine = make_engine()
    status, info = run_resilient(engine, drv.step_fn, str(tmp_path),
                                 max_steps=3, save_interval=2)
    assert status == "done" and info["steps"] == 3 and info["saves"] == 2
    assert newest_valid_tag(str(tmp_path)) == "global_step3"
    e2 = make_engine()
    status, info = run_resilient(e2, drv.step_fn, str(tmp_path),
                                 max_steps=5)
    assert status == "done" and e2.global_steps == 5


def _recording():
    losses = {}

    def step(engine):
        step_no = engine.global_steps + 1
        losses[step_no] = drv.step_fn(engine)

    return losses, step


def test_run_resilient_sigterm_preempt_then_resume_bitwise(tmp_path):
    losses, step = _recording()
    engine = make_engine()
    inject.configure_injection(
        {"point": "train.step_begin", "action": "sigterm", "at": 3})
    status, info = run_resilient(engine, step, str(tmp_path), max_steps=6,
                                 save_interval=10)
    assert status == "preempted" and engine.global_steps == 3
    assert any(t.startswith("preempt_") for t in list_tags(str(tmp_path)))
    inject.reset_injection()
    e2 = make_engine()
    status, info = run_resilient(e2, step, str(tmp_path), max_steps=6,
                                 save_interval=10)
    assert status == "done" and e2.global_steps == 6
    assert [losses[s] for s in range(1, 7)] == reference_losses(6)


def test_elastic_agent_checkpoint_if_preempted(tmp_path):
    """``DSElasticAgent.checkpoint_if_preempted`` on a training engine: a
    SIGTERM marks the run, the next boundary writes a ``preempt_*`` tag,
    and a fresh engine resumes from it bitwise."""
    import signal
    from deepspeed_tpu_torch.elasticity import DSElasticAgent
    engine = make_engine()
    agent = DSElasticAgent({}, checkpoint_dir=str(tmp_path)).start()
    try:
        train_steps(engine, 2)
        assert not agent.checkpoint_if_preempted(engine)
        os.kill(os.getpid(), signal.SIGTERM)
        assert agent.preempted
        assert agent.checkpoint_if_preempted(engine)
    finally:
        agent.stop()
    (tag,) = list_tags(str(tmp_path))
    assert tag.startswith("preempt_") and verify_manifest(
        str(tmp_path / tag)) == []
    want = train_steps(engine, 2)
    e2 = make_engine()
    e2.load_checkpoint(str(tmp_path))
    assert e2.global_steps == 2 and train_steps(e2, 2) == want


def test_run_resilient_hang_watchdog_recovers(tmp_path):
    losses, step = _recording()
    engine = make_engine(heartbeat_timeout_secs=0.5)
    inject.configure_injection(
        {"point": "train.step_begin", "action": "hang", "at": 2,
         "times": 1, "seconds": 30})
    status, info = run_resilient(engine, step, str(tmp_path), max_steps=4,
                                 save_interval=1)
    assert status == "done", info
    assert info["hangs"] == 1 and info["resumes"] >= 1
    assert any(t.startswith("hang_step") for t in list_tags(str(tmp_path)))
    assert [losses[s] for s in range(1, 5)] == reference_losses(4)


def test_run_resilient_transient_step_fault_reloads(tmp_path):
    engine = make_engine()
    inject.configure_injection(
        {"point": "train.step_begin", "action": "raise", "at": 3,
         "times": 1})
    status, info = run_resilient(engine, drv.step_fn, str(tmp_path),
                                 max_steps=4, save_interval=2)
    assert status == "done" and info["resumes"] == 1
    assert engine.global_steps == 4


def test_run_resilient_gives_up_after_max_resumes(tmp_path):
    engine = make_engine(max_resumes=2)
    inject.configure_injection(
        {"point": "train.step_begin", "action": "raise", "at": 2,
         "times": 0})                      # every step from 2 on faults
    status, info = run_resilient(engine, drv.step_fn, str(tmp_path),
                                 max_steps=10, save_interval=1)
    assert status == "failed" and info["resumes"] == 2


def test_elastic_resume_config_preserves_global_batch():
    cfg = {
        "elasticity": {"enabled": True, "max_train_batch_size": 64,
                       "micro_batch_sizes": [2, 4], "min_gpus": 1,
                       "max_gpus": 64, "version": 0.1},
        "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
    }
    c8 = elastic_resume_config(cfg, world_size=8)
    c4 = elastic_resume_config(cfg, world_size=4)
    assert c8["train_batch_size"] == c4["train_batch_size"]
    for c, w in ((c8, 8), (c4, 4)):
        assert c["train_micro_batch_size_per_gpu"] * \
            c["gradient_accumulation_steps"] * w == c["train_batch_size"]
    assert elastic_resume_config({"train_batch_size": 16}) == \
        {"train_batch_size": 16}


# --------------------------------------------------------------------- #
# The kill-and-resume proof (os._exit at every ckpt.* seam)
# --------------------------------------------------------------------- #
KILL_POINTS = (
    "ckpt.save_io",               # save begun, staging dir empty
    "ckpt.arrays_write",          # arrays written, metadata absent
    "ckpt.before_manifest",       # staging complete, manifest absent
    "ckpt.corrupt_shard",         # manifest durable, tag not promoted
    "ckpt.before_commit_rename",  # the same, one seam later
    "ckpt.before_latest_swap",    # tag promoted, pointer on the previous
)
MAX_STEPS = 9


def _run_driver(ckpt_dir, losses, inject_spec=None):
    env = dict(os.environ)
    env.pop(inject.ENV_VAR, None)
    if inject_spec:
        env[inject.ENV_VAR] = inject_spec
    return subprocess.run(
        [sys.executable, DRIVER, "--ckpt-dir", str(ckpt_dir),
         "--max-steps", str(MAX_STEPS), "--save-interval", "1",
         "--losses", str(losses)],
        env=env, capture_output=True, text=True, timeout=240)


def test_kill_at_every_seam_resumes_bitwise(tmp_path):
    """One run, killed once at each ``ckpt.*`` seam in turn: launch i
    resumes from the newest valid tag, commits one save and dies in its
    second at seam i; a last clean launch finishes.  Every step's
    recorded losses (a replayed step records again) equal the
    uninterrupted run's, bitwise."""
    want = {s + 1: repr(x) for s, x in
            enumerate(reference_losses(MAX_STEPS))}
    ckpt, losses = tmp_path / "ckpt", tmp_path / "losses.txt"
    for point in KILL_POINTS:
        proc = _run_driver(ckpt, losses, f"point={point},action=exit,at=2")
        assert proc.returncode == 17, \
            f"{point}: rc={proc.returncode}\n{proc.stderr[-3000:]}"
    proc = _run_driver(ckpt, losses)
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen = {}
    for line in losses.read_text().split():
        step, _, loss = line.partition(",")
        seen.setdefault(int(step), []).append(loss)
    assert sorted(seen) == list(range(1, MAX_STEPS + 1))
    for step, got in seen.items():
        assert set(got) == {want[step]}, f"step {step}: {got}"
    # six kills, each after one committed save of its launch
    assert sum(len(v) for v in seen.values()) > MAX_STEPS


# --------------------------------------------------------------------- #
# Tools and config
# --------------------------------------------------------------------- #
def test_ckpt_cli_verify_list_gc(tmp_path, capsys):
    engine = make_engine()
    for _ in range(3):
        train_steps(engine, 1)
        engine.save_checkpoint(str(tmp_path))
    assert ckpt_cli.main(["list", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "global_step3" in out and "<- latest" in out
    assert ckpt_cli.main(["verify", str(tmp_path)]) == 0
    target, _ = largest_array_file(str(tmp_path / "global_step2"))
    with open(target, "r+b") as f:
        f.write(b"\x00\x01\x02\x03")
    assert ckpt_cli.main(["verify", str(tmp_path)]) == 1
    assert "INVALID" in capsys.readouterr().out
    assert ckpt_cli.main(["gc", str(tmp_path), "--keep", "1",
                          "--dry-run"]) == 0
    assert len(list_tags(str(tmp_path))) == 3
    assert ckpt_cli.main(["gc", str(tmp_path), "--keep", "1"]) == 0
    assert list_tags(str(tmp_path)) == ["global_step3"]


def test_fault_config_defaults():
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.fault import FaultConfig
    cfg = DeepSpeedConfig({"train_micro_batch_size_per_gpu": 2})
    assert cfg.fault.enabled is False and cfg.nebula_config.enabled is False
    f = FaultConfig()
    assert (f.verify_on_load, f.checksum, f.keep_last_n, f.max_retries,
            f.max_resumes, f.heartbeat_timeout_secs,
            f.emergency_checkpoint_on_hang, f.save_interval) == \
        (True, "sha256", 0, 3, 10, 0.0, True, 0)
    assert DeepSpeedInferenceConfig(checkpoint="x").checkpoint == "x"
    assert DeepSpeedInferenceConfig(fault={"enabled": True}).fault[
        "enabled"] is True


def test_injection_spec_parsing():
    specs = inject.configure_injection(
        "point=ckpt.save_io,action=raise,at=2,times=3;"
        "point=train.step_begin,action=hang,seconds=0.5")
    assert (specs[0].point, specs[0].at, specs[0].times) == \
        ("ckpt.save_io", 2, 3)
    assert (specs[1].action, specs[1].seconds) == ("hang", 0.5)
    with pytest.raises(ValueError, match="unknown injection point"):
        inject.configure_injection({"point": "nope"})
    with pytest.raises(ValueError, match="unknown injection action"):
        inject.configure_injection({"point": "ckpt.save_io",
                                    "action": "nope"})
    with pytest.raises(ValueError, match="needs the seam to provide"):
        inject.configure_injection({"point": "ckpt.corrupt_shard",
                                    "action": "corrupt"})
        inject.fire("ckpt.corrupt_shard")


# --------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_save_and_load_land_on_the_device(cuda, tmp_path):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import (Transformer,
                                                        TransformerConfig)

    def engine(seed):
        # heads of 64: a width the attention kernels take
        model = Transformer(TransformerConfig(**dict(
            drv.MODEL, hidden_size=128, num_heads=2)))
        e, *_ = deepspeed_tpu_torch.initialize(
            model=model, config=dict(drv.CONFIG, seed=seed), device=cuda)
        return e

    a = engine(1)
    for _ in range(2):
        drv.step_fn(a)
    a.save_checkpoint(str(tmp_path))
    b = engine(2)
    b.load_checkpoint(str(tmp_path))
    live = b._checkpoint_arrays()
    tensors = list(live["module"].values()) + list(live["loss_scaler"]) + \
        [t for f in live["optimizer"] for t in f]
    assert all(t.device.type == "cuda" for t in tensors)
    for x, y in zip(b.params, a.params):
        assert torch.equal(x, y)
    assert drv.step_fn(b) == drv.step_fn(a)


@pytest.mark.cuda
def test_cuda_async_commit_orders_meta_after_arrays(cuda, tmp_path):
    from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine \
        import NebulaCheckpointEngine
    neb = NebulaCheckpointEngine()
    big = torch.randn(64 << 20, device=cuda)          # 256 MB
    path = str(tmp_path / "state")
    neb.save({"module": {"w": big}}, {"global_steps": 1}, path)
    assert not os.path.exists(os.path.join(path, "meta.pkl"))
    neb.commit("tag")
    meta_t = os.path.getmtime(os.path.join(path, "meta.pkl"))
    arr = os.path.join(path, "arrays", "module", "w.pt")
    assert os.path.getmtime(arr) <= meta_t
    arrays, _ = neb.load(path)
    assert torch.equal(arrays["module"]["w"], big.cpu())
