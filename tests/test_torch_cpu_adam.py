"""The port's host optimizer kernels against the JAX package's binding of
the same C++ source, on the CPU, from the same numpy inputs.

- ``adam_step`` (``csrc/adam/cpu_adam.cpp`` ``ds_adam_step``, built by the
  port's ``ops/native_build.py``) against JAX's ``cpu_adam.adam_step``,
  **bitwise**, over 3 steps, for ``adamw_mode`` 0 / 1, bias correction on
  / off, weight decay 0 / 0.01, with and without the bf16 copy-out: both
  packages compile the source with the same flags, so they run the same
  machine code.  Skipped, with that reason, where JAX's binding did not
  build (it falls back to numpy, which is not the same arithmetic).
- ``adagrad_step`` the same way (weight decay 0 / 0.01, bf16 on / off);
- each kernel against its plain PyTorch version at 1e-6 relative (the
  compiler may contract to FMA under ``-march=native``); the bf16 copy-out
  is the round-to-nearest-even of the kernel's own fp32 result, bitwise;
- ``DeepSpeedCPUAdam`` / ``DeepSpeedCPUAdagrad`` against the JAX classes,
  bitwise;
- the build (``tests/test_torch_package_hygiene.py`` holds where the
  libraries land): a compile that fails (a broken source, a flag the compiler refuses, as a missing
  ``-fopenmp`` would be) raises with the compiler's output, and nothing
  is loaded in its place.
"""

import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adagrad import DeepSpeedCPUAdagrad as JAdagrad
from deepspeed_tpu.ops.adam import cpu_adam as jcpu

from deepspeed_tpu_torch.ops import native_build
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.adagrad import DeepSpeedCPUAdagrad
from deepspeed_tpu_torch.ops.adam import cpu_adam as pcpu

N = 4099          # not a multiple of any vector width
PLAIN = dict(rtol=1e-6, atol=1e-7)


def jax_native():
    if not jcpu.is_available():
        pytest.skip(f"the JAX binding fell back to numpy (not the C++ "
                    f"kernel): {jcpu.build_error()}")


def draw(seed, n=N):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(2)]


def t(a):
    return torch.from_numpy(a.copy())


ADAM_CASES = [(mode, bc, wd, bf) for mode in (0, 1) for bc in (0, 1)
              for wd in (0.0, 0.01) for bf in (False, True)]


@pytest.mark.parametrize("mode,bc,wd,bf", ADAM_CASES,
                         ids=[f"adamw{m}-bc{b}-wd{w}-{'bf16' if f else 'f32'}"
                              for m, b, w, f in ADAM_CASES])
def test_adam_step_bitwise_jax(mode, bc, wd, bf):
    jax_native()
    p, _ = draw(1)
    jp, jm, jv = p.copy(), np.zeros(N, np.float32), np.zeros(N, np.float32)
    pp, pm, pv = t(p), torch.zeros(N), torch.zeros(N)
    for step in (1, 2, 3):
        g = draw(10 + step)[1]
        jout = np.zeros(N, np.uint16) if bf else None
        pout = torch.zeros(N, dtype=torch.uint16) if bf else None
        jcpu.adam_step(jp, jm, jv, g, 1e-2, 0.9, 0.999, 1e-8, wd, mode, bc,
                       step, bf16_out=jout)
        pcpu.adam_step(pp, pm, pv, t(g), 1e-2, 0.9, 0.999, 1e-8, wd, mode,
                       bc, step, bf16_out=pout)
        for got, want in ((pp, jp), (pm, jm), (pv, jv)):
            assert np.array_equal(got.numpy(), want)
        if bf:
            assert np.array_equal(pout.numpy(), jout)


ADAGRAD_CASES = [(wd, bf) for wd in (0.0, 0.01) for bf in (False, True)]


@pytest.mark.parametrize("wd,bf", ADAGRAD_CASES,
                         ids=[f"wd{w}-{'bf16' if f else 'f32'}"
                              for w, f in ADAGRAD_CASES])
def test_adagrad_step_bitwise_jax(wd, bf):
    jax_native()
    p, _ = draw(2)
    jp, jv = p.copy(), np.zeros(N, np.float32)
    pp, pv = t(p), torch.zeros(N)
    for step in (1, 2, 3):
        g = draw(20 + step)[1]
        jout = np.zeros(N, np.uint16) if bf else None
        pout = torch.zeros(N, dtype=torch.uint16) if bf else None
        jcpu.adagrad_step(jp, jv, g, 1e-2, 1e-10, wd, bf16_out=jout)
        pcpu.adagrad_step(pp, pv, t(g), 1e-2, 1e-10, wd, bf16_out=pout)
        assert np.array_equal(pp.numpy(), jp)
        assert np.array_equal(pv.numpy(), jv)
        if bf:
            assert np.array_equal(pout.numpy(), jout)


@pytest.mark.parametrize("mode,bc,wd", [(1, 1, 0.01), (0, 1, 0.01),
                                        (1, 0, 0.0)])
def test_adam_step_matches_plain(mode, bc, wd):
    p, _ = draw(3)
    a = [t(p), torch.zeros(N), torch.zeros(N)]
    b = [t(p), torch.zeros(N), torch.zeros(N)]
    for step in (1, 2, 3):
        g = t(draw(30 + step)[1])
        out = torch.zeros(N, dtype=torch.uint16)
        pcpu.adam_step(*a, g, 1e-2, 0.9, 0.999, 1e-8, wd, mode, bc, step,
                       bf16_out=out)
        pcpu.adam_step_plain(*b, g, 1e-2, 0.9, 0.999, 1e-8, wd, mode, bc,
                             step)
        for got, want in zip(a, b):
            torch.testing.assert_close(got, want, **PLAIN)
        assert torch.equal(out, pcpu.bf16_bits(a[0]))


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adagrad_step_matches_plain(wd):
    p, _ = draw(4)
    a, b = [t(p), torch.zeros(N)], [t(p), torch.zeros(N)]
    for step in (1, 2, 3):
        g = t(draw(40 + step)[1])
        out = torch.zeros(N, dtype=torch.bfloat16)
        pcpu.adagrad_step(*a, g, 1e-2, 1e-10, wd, bf16_out=out)
        pcpu.adagrad_step_plain(*b, g, 1e-2, 1e-10, wd)
        for got, want in zip(a, b):
            torch.testing.assert_close(got, want, **PLAIN)
        assert torch.equal(out, a[0].to(torch.bfloat16))


def test_optimizer_classes_bitwise_jax():
    jax_native()
    shapes = [(7, 5), (33,), (3, 4, 2)]
    rng = np.random.default_rng(5)
    params = [rng.standard_normal(s).astype(np.float32).ravel()
              for s in shapes]
    # the JAX classes keep (and update) contiguous fp32 arrays themselves
    ja = jcpu.DeepSpeedCPUAdam([p.copy() for p in params], lr=1e-2,
                               weight_decay=0.01)
    pa = pcpu.DeepSpeedCPUAdam([t(p) for p in params], lr=1e-2,
                               weight_decay=0.01)
    jg = JAdagrad([p.copy() for p in params], lr=1e-2)
    pg = DeepSpeedCPUAdagrad([t(p) for p in params], lr=1e-2)
    for _ in range(3):
        grads = [rng.standard_normal(p.size).astype(np.float32)
                 for p in params]
        for j, p in ((ja, pa), (jg, pg)):
            jout = [np.zeros(x.size, np.uint16) for x in params]
            pout = [torch.zeros(x.size, dtype=torch.uint16) for x in params]
            j.step(grads, bf16_outs=jout, lr=2e-2)
            p.step([t(g) for g in grads], bf16_outs=pout, lr=2e-2)
            for a, b in zip(p.params, j.params):
                assert np.array_equal(a.numpy(), b)
            for a, b in zip(pout, jout):
                assert np.array_equal(a.numpy(), b)
    assert pa.step_count == ja.step_count == 3
    for a, b in zip(pa.exp_avg_sq, ja.exp_avg_sq):
        assert np.array_equal(a.numpy(), b)


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++;\n")
    with pytest.raises(RuntimeError, match="failed to build host library"):
        native_build.load_library("ds_bad", [str(bad)])
    good = tmp_path / "good.cpp"
    good.write_text('extern "C" int f() { return 1; }\n')
    # a flag the compiler refuses, as a g++ without OpenMP refuses
    # -fopenmp: no flag set is tried in its place
    monkeypatch.setattr(native_build, "OPENMP_FLAGS", ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="-fno-such-flag"):
        native_build.load_library("ds_good", [str(good)])
    assert not list(tmp_path.glob("ds_good-*.so"))
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_build.load_library("ds_good2", [str(good)], want_openmp=False)


def test_compiler_choice(tmp_path, monkeypatch):
    """``$CXX``, else the first ``g++`` on ``PATH``; for the OpenMP library
    the first of them that links OpenMP: a toolchain without
    ``libgomp.spec``, in ``$CXX`` or ahead on ``PATH``, is passed over;
    with none that has it, the build raises."""
    monkeypatch.delenv("CXX", raising=False)
    fake = tmp_path / "bin"
    fake.mkdir()
    (fake / "g++").write_text("#!/bin/sh\necho libgomp.spec\n")
    (fake / "g++").chmod(0o755)
    real = os.path.join(os.path.dirname(native_build.compiler(True)), "g++")
    monkeypatch.setenv("PATH", f"{fake}{os.pathsep}{os.path.dirname(real)}")
    assert native_build.compiler(True) == real
    assert native_build.compiler(False) == str(fake / "g++")
    monkeypatch.setenv("CXX", str(fake / "g++"))
    assert native_build.compiler(True) == real
    assert native_build.compiler(False) == str(fake / "g++")
    monkeypatch.delenv("CXX")
    monkeypatch.setenv("PATH", str(fake))
    with pytest.raises(RuntimeError, match="with OpenMP"):
        native_build.compiler(True)


def test_kernel_refuses_wrong_buffers():
    p = torch.zeros(8)
    with pytest.raises(TypeError, match="float32"):
        pcpu.adam_step(p, torch.zeros(8, dtype=torch.float64),
                       torch.zeros(8), torch.zeros(8), 1e-3, 0.9, 0.999,
                       1e-8, 0.0, 1, 1, 1)
    with pytest.raises(ValueError, match="elements"):
        pcpu.adam_step(p, torch.zeros(7), torch.zeros(8), torch.zeros(8),
                       1e-3, 0.9, 0.999, 1e-8, 0.0, 1, 1, 1)
    with pytest.raises(TypeError, match="bf16_out"):
        pcpu.adagrad_step(p, torch.zeros(8), torch.zeros(8), 1e-2, 1e-10,
                          0.0, bf16_out=torch.zeros(8))
