"""The trace's arithmetic on a made-up span: busy as the union, gaps to
the innermost host operation, classes, the roofline share."""

import pytest

from chbench.spec import Bench
from chbench.trace import TraceContext, base_name


def test_base_names():
    assert base_name('void mu_kernel<float>(float const*, float*, long '
                     'long)') == 'mu_kernel'
    assert base_name('void at::native::vectorized_elementwise_kernel<4, '
                     'at::native::X>(int, at::native::X)') == \
        'vectorized_elementwise_kernel'
    assert base_name('Memcpy DtoH (Device -> Pinned)') == 'Memcpy DtoH'
    assert base_name('void (anonymous namespace)::elementwise_kernel_with_'
                     'index<int>(int)') == 'elementwise_kernel_with_index'
    assert base_name('sm90_xmma_gemm_f64f64_f64f64_f64_nt_n_tilesize64x64'
                     'x16') == 'sm90_xmma_gemm_f64f64_f64f64_f64_nt_n_tile' \
        'size64x64x16'


def test_context_sums():
    bench = Bench()
    N, R = 1024, 1
    # stats_kernel 2 fields of float32: 8 MiB at 3.35 TB/s = 2.504 us;
    # it takes 5 us
    ev = [('step', 0.0, 100.0, False),
          ('aten::add', 10.0, 20.0, False),
          ('void stats_kernel<float, 0>(float const*)', 10.0, 15.0, True),
          ('void regular_fft<128>(float2*)', 14.0, 30.0, True),
          ('void at::native::elementwise_kernel<4>(int)', 60.0, 70.0, True)]
    ctx = TraceContext(ev, 2, (R, N, 4), bench.kernels(),
                       bench.classes(), {})
    assert ctx.span_s == pytest.approx(100e-6)
    assert ctx.busy_s == pytest.approx(30e-6)
    assert ctx.idle_pct() == pytest.approx(70.0)
    assert ctx.ms_per_step('kernels') == pytest.approx(5e-6 * 1e3 / 2)
    assert ctx.ms_per_step('transform') == pytest.approx(16e-6 * 1e3 / 2)
    assert ctx.ms_per_step('eager') == pytest.approx(10e-6 * 1e3 / 2)
    assert ctx.ops_per_step() == 1.5
    bound = 2 * N * N * 4 / 3.35e12
    assert ctx.roofline_pct() == pytest.approx(100 * bound / 5e-6)
    gaps = dict(ctx.idle_by_host)
    # 0-10 and 70-100 under 'step'; 30-60 under 'step' too (add ended)
    assert gaps == pytest.approx({'step': 70e-6})
    bd = ctx.breakdown()
    assert bd['device_ops'][0][0].startswith('regular_fft<128>')


def test_no_device_ops_reads_nothing():
    ctx = TraceContext([('step', 0.0, 10.0, False)], 3,
                       (1, 64, 4), {}, {}, {})
    assert ctx.roofline_pct() is None and ctx.ms_per_step('eager') is None
    assert ctx.idle_pct() is None
