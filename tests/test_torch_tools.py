"""PyTorch port, the tuning kernels and their tools on the CPU: the plain
versions of `ops/window_kernels.py` against the JAX package's three
prototype scripts, which are loaded by path and run through the Pallas
interpreter, and the tools' draws, failure handling and device rule.

Tolerances: 1e-5 on sampled values in [0, 1] (float32 sums in another
order); the bf16 matrix-unit output within one bf16 ulp of the value
(2^-7 relative).  On the CPU interpreter the TPU's HIGH and DEFAULT
matrix-unit precisions compute in float32, so the plain version's TF32
rounding is held against a numpy statement of the same rounding here and
against the kernel on the card (tests/test_torch_cuda.py).
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

REPO = pathlib.Path(__file__).resolve().parent.parent
V, H, W, J = 5, 128, 240, 15


@functools.lru_cache(maxsize=None)
def _script(name):
    """A script of scripts/ as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _heatmaps(seed=0):
    return np.random.RandomState(seed).rand(V, H, W, J).astype(np.float32)


def _interpreted(sweep, s, xw, yw, precision, contract):
    """scripts/sweep_pallas.py's make_fn with the interpreter switched on:
    the same kernel, grid and block specs (the script has no such switch)."""
    kern = sweep.make_kernel(s, xw, yw, precision, contract)

    def fn(hm_packed, coords):
        n_blocks = coords.shape[0]
        return pl.pallas_call(
            kern,
            grid=(n_blocks,),
            in_specs=[pl.BlockSpec((1, V, 2, s), lambda i: (i, 0, 0, 0), memory_space=pltpu.VMEM),
                      pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((1, sweep.JP, s), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((n_blocks, sweep.JP, s), jnp.float32),
            interpret=True,
        )(coords, hm_packed)

    return fn


def test_window_plain_matches_probe_kernel():
    """Row 5: window_sample (the plain version, on the CPU) against
    pallas_sample_fixed in interpret mode, and both against the exact
    sampler at the probe's spread of 10, which its 24 x 24 window covers."""
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools import probe_sampling as ps

    probe = _script("probe_pallas")
    assert probe.INTERPRET
    hm = _heatmaps()
    coords = ps.make_block_coords(3, np.random.RandomState(1))
    ref = np.asarray(probe.pallas_sample_fixed(probe.pack_hm(jnp.asarray(hm)), jnp.asarray(coords)))
    hm_t, coords_t = torch.as_tensor(hm), torch.as_tensor(coords)
    out = wk.window_sample(hm_t, coords_t, wk.PROBE_CONFIG).numpy()
    assert out.shape == ref.shape == (3, 16, 256)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out[:, 15], 0.0)
    np.testing.assert_allclose(out, ps.exact_reference(hm_t, coords_t).numpy(), atol=1e-5, rtol=0)
    sweep = _script("sweep_pallas")  # the kernel's packing: the sweep's for contract y
    np.testing.assert_array_equal(np.asarray(sweep.pack_hm(jnp.asarray(hm), "y")),
                                  wk.pack_heatmap(hm_t).numpy())


SHAPES = [(256, 24, 24, "x"), (256, 24, 24, "y"), (128, 16, 40, "y"), (256, 24, 40, "y"),
          (512, 16, 40, "y")]


@pytest.mark.parametrize("spread", [6.0, 12.0])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "S{}-{}x{}-{}".format(*s))
def test_window_plain_matches_sweep_kernel(shape, spread):
    """Row 6: the plain version against make_kernel over the distinct
    (S, XW, YW, contract) shapes of the sweep's nine configs, at a spread
    every window covers (6) and at the sweep's default (12), where the
    16-wide windows cut samples off: both give the window's answer, and
    only the covered spread also gives the exact sampler's."""
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools import probe_sampling as ps
    from faster_voxelpose_tpu_torch.tools import sweep_sampling as sw

    sweep = _script("sweep_pallas")
    s, xw, yw, contract = shape
    hm = _heatmaps(2)
    coords = sw.sweep_coords(3, s, spread, np.random.RandomState(3))
    packed = sweep.pack_hm(jnp.asarray(hm), contract)
    ref = np.asarray(_interpreted(sweep, s, xw, yw, jax.lax.Precision.HIGH, contract)(
        packed, jnp.asarray(coords)))
    hm_t, coords_t = torch.as_tensor(hm), torch.as_tensor(coords)
    out = wk.window_sample_plain(hm_t, coords_t, wk.WindowConfig(s, xw, yw, "fp32", contract)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    if contract == "y":  # the kernel's packing, for either axis
        np.testing.assert_array_equal(np.asarray(packed), wk.pack_heatmap(hm_t).numpy())
    err_exact = np.abs(out - ps.exact_reference(hm_t, coords_t).numpy()).max()
    if spread <= min(xw, yw) - 9:
        assert err_exact <= 1e-5
    elif xw == 16:
        assert err_exact > 1e-2  # the sweep's finding, not a fault


def test_tf32_rounding_is_the_stated_one():
    """tf32_round against numpy: add half an ulp of the 10-bit mantissa to
    the magnitude bits, clear the low 13 bits (nearest, ties away from
    zero); the split parts are TF32 values that sum back to 2^-21."""
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk

    rng = np.random.RandomState(4)
    x = np.concatenate([rng.randn(4096), rng.rand(4096), [0.0, 1.0, -1.0, 1.0 + 2.0 ** -11,
                                                          -(1.0 + 2.0 ** -11), 3.0e-5]]).astype(np.float32)
    want = ((x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    got = wk.tf32_round(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got.view(np.uint32) & np.uint32(0x1FFF) == 0)
    assert np.all(np.abs(got - x) <= np.abs(x) * 2.0 ** -11)
    assert got[-3] == np.float32(1.0 + 2.0 ** -10) and got[-2] == np.float32(-(1.0 + 2.0 ** -10))
    hi, lo = (t.numpy() for t in wk.tf32_split(torch.as_tensor(x)))
    np.testing.assert_array_equal(hi, want)
    assert np.all(lo.view(np.uint32) & np.uint32(0x1FFF) == 0)
    assert np.all(np.abs(hi.astype(np.float64) + lo - x) <= np.abs(x) * 2.0 ** -21)


@pytest.mark.parametrize("prec,tol", [("tf32x3", 1e-5), ("tf32", 2e-3)])
def test_window_plain_precisions(prec, tol):
    """The split product recovers float32 to the tolerance; one TF32
    product does not (it is off by more than 1e-5) but stays near."""
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools import sweep_sampling as sw

    hm_t = torch.as_tensor(_heatmaps(5))
    coords_t = torch.as_tensor(sw.sweep_coords(3, 256, 6.0, np.random.RandomState(6)))
    full = wk.window_sample_plain(hm_t, coords_t, wk.WindowConfig(256, 24, 24, "fp32", "x"))
    out = wk.window_sample_plain(hm_t, coords_t, wk.WindowConfig(256, 24, 24, prec, "x"))
    err = float((out - full).abs().max())
    assert err <= tol
    if prec == "tf32":
        assert err > 1e-5


@pytest.mark.parametrize("dyn", [False, True])
@pytest.mark.parametrize("k", [128, 64, 32])
def test_mma_window_plain_matches_dot_general(k, dyn):
    """Row 7.  The script's kernel body is nested inside bench() and
    returns nothing, so it cannot be called; the plain version is held
    against the same contraction written out here with
    jax.lax.dot_general (bf16 in, float32 accumulate, nmat sums, first 8
    rows, mean, bf16 out), as scripts/microbench_matmul.py:31-46 has it,
    at M = 32, N = 64, B = 3."""
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk

    M, N, B, nmat = 32, 64, 3, 5
    rng = np.random.RandomState(k + dyn)
    lhs = jnp.asarray(rng.rand(128, M), jnp.bfloat16)
    rhs = jnp.asarray(rng.rand(B, 128, N), jnp.bfloat16)
    oy = (rng.randint(0, (128 - k) // 16 + 1, B) * 16).astype(np.int32)
    want = []
    for b in range(B):
        o = int(oy[b]) if dyn else 0
        acc = jnp.zeros((M, N), jnp.float32)
        for _ in range(nmat):
            acc += jax.lax.dot_general(lhs[o:o + k], rhs[b, :k], (((0,), (0,)), ((), ())),
                                       preferred_element_type=jnp.float32)
        want.append((acc[:8] * (1.0 / nmat)).astype(jnp.bfloat16))
    want = np.asarray(jnp.stack(want).astype(jnp.float32))

    def to_torch(a):
        return torch.as_tensor(np.array(a.astype(jnp.float32))).to(torch.bfloat16)

    out = wk.mma_window(to_torch(lhs), to_torch(rhs), torch.as_tensor(oy) if dyn else None, k, nmat)
    assert out.shape == (B, 8, N) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want, atol=0, rtol=2.0 ** -7)


# as an H100 reports them (cudaDeviceGetAttribute): SMs, shared memory per
# SM, and the most one block may opt in to (227 KB)
H100 = (132, 233_472, 232_448)
H100_SMS, _, H100_SMEM_PER_BLOCK = H100


@pytest.mark.parametrize("m", [16, 320, 640])
@pytest.mark.parametrize("k", [128, 64, 32])
def test_mma_plan_fits_a_block(k, m):
    """Row 7's launch plan at the tool's N and B on an H100: the stages fit
    227 KB per block, A takes as many stages as fit (up to 8), and one
    persistent block per SM."""
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk

    plan = wk.mma_plan(m, 2048, k, 512, *H100)
    assert plan.smem == wk.mma_smem_bytes(k, plan.a_stages) <= H100_SMEM_PER_BLOCK
    assert wk.MMA_B_STAGES == 2 and 2 <= plan.a_stages <= wk.MMA_MAX_A_STAGES
    if plan.a_stages < wk.MMA_MAX_A_STAGES:
        assert wk.mma_smem_bytes(k, plan.a_stages + 1) > H100_SMEM_PER_BLOCK
    assert (plan.tile_m, plan.tile_n, plan.blocks_per_sm, plan.grid) == (128, 256, 1, H100_SMS)
    assert plan.tiles_per_step == -(-m // 128) * 8
    assert {128: 3, 64: 8, 32: 8}[k] == plan.a_stages


@pytest.mark.parametrize("m", [16, 320, 640])
@pytest.mark.parametrize("k", [128, 64, 32])
def test_mma_plan_covers_each_row_and_column_once(k, m):
    """The persistent blocks' tiles, walked as the kernel walks them, cover
    every (step, row, column) of the product exactly once, for ragged and
    whole column tiles."""
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk

    steps = 3
    for n in (64, 192, 2048):
        plan = wk.mma_plan(m, n, k, steps, *H100)
        assert plan.grid == min(steps * plan.tiles_per_step, H100_SMS)
        tiles = [t for block in range(plan.grid) for t in wk.mma_schedule(plan, steps, block)]
        assert len(tiles) == len(set(tiles)) == steps * plan.tiles_per_step
        count = np.zeros((steps, m, n), np.int32)
        for b, n0, m0 in tiles:
            count[b, m0:m0 + plan.tile_m, n0:n0 + plan.tile_n] += 1
        assert (count == 1).all()


@pytest.mark.parametrize("m", [16, 320, 640])
@pytest.mark.parametrize("k", [128, 64, 32])
def test_mma_plan_wraps_over_steps(k, m):
    """With 2 * SMs + 1 steps of one column tile, each block's run of
    tiles, in (step, row tile) order, spans two or three steps, the runs
    follow each other, and every step's row tile 0 goes to one block."""
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk

    steps = 2 * H100_SMS + 1
    plan = wk.mma_plan(m, 192, k, steps, *H100)
    assert plan.grid == H100_SMS and plan.n_tiles == 1
    walks = [wk.mma_schedule(plan, steps, block) for block in range(plan.grid)]
    assert all(len({b for b, _, _ in w}) in (2, 3) for w in walks)
    flat = [t for w in walks for t in w]
    assert flat == sorted(flat, key=lambda t: (t[0], t[2]))
    assert flat[0] == (0, 0, 0) and flat[-1] == (steps - 1, 0, 128 * (plan.m_tiles - 1))
    assert sorted(b for w in walks for b, _, m0 in w if m0 == 0) == list(range(steps))


def test_tool_draws_match_the_scripts():
    """make_block_coords and the sweep's coordinate draws equal the
    scripts' for one seed (the sweep draws inline in its main(),
    scripts/sweep_pallas.py:167-171, repeated here)."""
    from faster_voxelpose_tpu_torch.tools import microbench_mma as mb
    from faster_voxelpose_tpu_torch.tools import probe_sampling as ps
    from faster_voxelpose_tpu_torch.tools import sweep_sampling as sw

    probe, sweep = _script("probe_pallas"), _script("sweep_pallas")
    np.testing.assert_array_equal(ps.make_block_coords(7, np.random.RandomState(0)),
                                  probe.make_block_coords(7, np.random.RandomState(0)))
    assert (ps.V, ps.J, ps.W, ps.H, ps.K, ps.CUBE) == (probe.V, probe.J, probe.W, probe.H,
                                                       probe.K, probe.CUBE)
    rng, n_blocks, s, spread = np.random.RandomState(0), 5, 128, 12.0
    coords = np.empty((n_blocks, sweep.V, 2, s), np.float32)
    cx = rng.uniform(-10, sweep.W + 10, (n_blocks, sweep.V, 1))
    cy = rng.uniform(-10, sweep.H + 10, (n_blocks, sweep.V, 1))
    coords[:, :, 0, :] = cx + rng.uniform(-spread / 2, spread / 2, (n_blocks, sweep.V, s))
    coords[:, :, 1, :] = cy + rng.uniform(-spread / 2, spread / 2, (n_blocks, sweep.V, s))
    np.testing.assert_array_equal(sw.sweep_coords(n_blocks, s, spread, np.random.RandomState(0)), coords)
    micro = _script("microbench_matmul")
    assert (mb.M, mb.N, mb.B) == (micro.M, micro.N, micro.B)
    assert mb.CASES == tuple((k, dyn) for k in (128, 64, 32) for dyn in (False, True))


def test_sweep_configs_are_the_scripts_nine():
    """SWEEP_CONFIGS repeats scripts/sweep_pallas.py:152-163 in order,
    with HIGHEST / HIGH / DEFAULT as fp32 / tf32x3 / tf32."""
    import ast

    from faster_voxelpose_tpu_torch.ops import window_kernels as wk

    source = (REPO / "scripts/sweep_pallas.py").read_text()
    tree = ast.parse(source)
    configs = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", "") == "configs")
    names = {"HIGHEST": "fp32", "HIGH": "tf32x3", "DEFAULT": "tf32"}
    want = [wk.WindowConfig(e.elts[0].value, e.elts[1].value, e.elts[2].value,
                            names[e.elts[3].attr], e.elts[4].value) for e in configs.elts]
    assert list(wk.SWEEP_CONFIGS) == want and len(want) == 9
    assert wk.PROBE_CONFIG == wk.SWEEP_CONFIGS[0]


def test_tools_run_on_the_cpu_when_asked(monkeypatch, capsys):
    """probe_sampling and sweep_sampling end to end at a few blocks on the
    CPU (the plain versions), timed once instead of 28 times."""
    from faster_voxelpose_tpu_torch.tools import probe_sampling as ps
    from faster_voxelpose_tpu_torch.tools import sweep_sampling as sw

    def once(fn, **_):
        fn()
        return 1.0

    monkeypatch.setattr(ps, "time_ms", once)
    monkeypatch.setattr(sw, "time_ms", once)
    res = ps.main(["--blocks", "2", "--device", "cpu"])
    assert res["err"] < 1e-5 and res["samples"] == 2 * 256 * 5
    rows = sw.main(["6", "--samples", "512", "--device", "cpu"])
    assert [r["config"] for r in rows] == list(sw.wk.SWEEP_CONFIGS)
    assert all(r["err"] <= 1e-5 for r in rows if r["config"].prec != "tf32")
    out = capsys.readouterr().out
    assert "speedup of the window over the gather" in out and out.count("ns/sample") == 11
    assert "CPU, host clock" in out


def test_sweep_reports_a_failed_config_and_fails(monkeypatch, capsys):
    """A configuration that fails prints FAILED, the others still run, and
    the tool ends with an error (the script swallowed it)."""
    from faster_voxelpose_tpu_torch.tools import sweep_sampling as sw

    real = sw.wk.window_sample

    def flaky(hm, coords, cfg):
        if cfg.s == 128:
            raise RuntimeError("window_sample: CUDA error 1 at launch")
        return real(hm, coords, cfg)

    monkeypatch.setattr(sw.wk, "window_sample", flaky)
    monkeypatch.setattr(sw, "time_ms", lambda fn, **_: 1.0)
    with pytest.raises(RuntimeError, match="1 of 9 configurations failed"):
        sw.main(["6", "--samples", "512", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("FAILED window_sample: CUDA error 1") == 1 and out.count("ns/sample") == 8


@pytest.mark.parametrize("tool", ["probe_sampling", "sweep_sampling", "microbench_mma", "validate"])
def test_tools_need_cuda_unless_asked_for_the_cpu(monkeypatch, tool):
    module = importlib.import_module(f"faster_voxelpose_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])


def test_microbench_operands_and_cpu_path():
    from faster_voxelpose_tpu_torch.ops import window_kernels as wk
    from faster_voxelpose_tpu_torch.tools import microbench_mma as mb

    lhs, rhs, oy = mb.make_operands(4, 64, torch.device("cpu"), m=32, n=64)
    assert lhs.shape == (128, 32) and rhs.shape == (4, 128, 64) and lhs.dtype == torch.bfloat16
    assert oy.dtype == torch.int32 and bool(((oy % 16 == 0) & (oy >= 0) & (oy <= 64)).all())
    again = mb.make_operands(4, 64, torch.device("cpu"), m=32, n=64)
    assert all(torch.equal(a, b) for a, b in zip((lhs, rhs, oy), again))
    out = wk.mma_window(lhs, rhs, oy, 64)  # CPU tensors: the plain version
    assert torch.equal(out, wk.mma_window_plain(lhs, rhs, oy, 64))
    with pytest.raises(ValueError, match="grad"):
        wk.window_sample(torch.rand(V, H, W, J, requires_grad=True),
                         torch.zeros(1, V, 2, 256), wk.PROBE_CONFIG)


def test_timers_arithmetic_on_a_fake_clock():
    """tools/timing.py's device and host readings: the median of the
    readings, each of n calls, divided by n.  A fake clock advances by each
    call's own duration; the CPU takes the back-to-back path (the graph
    path needs the card: tests/test_torch_cuda.py)."""
    from faster_voxelpose_tpu_torch.tools import timing

    now = [0.0]

    def fn():
        now[0] += next(durations)

    class FakeClock:
        def start(self):
            self.t0 = now[0]

        def stop(self):
            return now[0] - self.t0

    # 1 warm call, one run of n = 4 before the readings, then 3 readings of
    # n = 4: totals 8, 12, 40 -> median 12 -> 3 ms per call
    durations = iter([9.0] * 5 + [2.0] * 4 + [3.0] * 4 + [10.0] * 4)
    ms, how = timing.device_timing(fn, n=4, reps=3, warm=1, device=torch.device("cpu"),
                                   clock=FakeClock())
    assert (ms, how) == (3.0, "back to back")
    # host_ms reads seconds: 1 warm call, then totals 0.004, 0.020, 0.008 s
    durations = iter([1.0] + [0.001] * 4 + [0.005] * 4 + [0.002] * 4)
    got = timing.host_ms(fn, n=4, reps=3, warm=1, device=torch.device("cpu"), now=lambda: now[0])
    assert abs(got - 2.0) < 1e-9
    assert timing.per_call_ms([8.0, 40.0, 12.0], 4) == 3.0
