"""Where the kernels run, the compile cache's location, and the peak table."""
import jax
import pytest

from gemma_tpu import compile_cache
from gemma_tpu.ops import _backend
from gemma_tpu.utils import device, profiling


def test_no_interpret_mode_without_the_hook():
    assert jax.default_backend() == "cpu"
    assert not _backend.interpret()
    assert not any(_backend.use_kernels(op) for op in _backend.OPS)


def test_interpret_hook_sets_and_resets():
    with _backend.interpret_kernels():
        assert _backend.interpret() and _backend.use_kernels("matmul")
        with _backend.plain_path("attention"):
            assert _backend.use_kernels("matmul")
            assert not _backend.use_kernels("attention")
            with _backend.plain_path():
                assert not _backend.use_kernels("matmul")
                assert _backend.interpret()  # the pallas_call argument is unchanged
        assert _backend.use_kernels("matmul") and _backend.use_kernels("attention")
    assert not _backend.interpret() and not _backend.use_kernels("matmul")
    with pytest.raises(ValueError):
        with _backend.plain_path("softmax"):
            pass


def test_interpret_hook_resets_on_error():
    with pytest.raises(ValueError):
        with _backend.interpret_kernels():
            raise ValueError
    assert not _backend.interpret()


def test_interpret_hook_refuses_a_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _backend.use_kernels("matmul")  # compiled kernels on the GPU
    assert not _backend.interpret()
    with pytest.raises(RuntimeError):
        with _backend.interpret_kernels():
            pass


def test_compile_cache_prefers_the_env_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    before = jax.config.jax_compilation_cache_dir
    compile_cache.setup_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before  # not set in code


def test_compile_cache_repo_default(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        compile_cache.setup_compile_cache()
        assert compile_cache.cache_dir() == compile_cache.REPO_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == compile_cache.REPO_CACHE_DIR
        assert compile_cache.REPO_CACHE_DIR.endswith(".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_peak_table_has_the_h100():
    p = device.peaks_for("NVIDIA H100 80GB HBM3")
    assert p.hbm_gbs == 3350.0 and p.bf16_flops == 989e12
    assert device.peaks_for("NVIDIA H100 PCIe").hbm_gbs == 2000.0


def test_unknown_device_raises():
    with pytest.raises(device.UnknownDevice):
        device.peaks_for("NVIDIA A100-SXM4-80GB")
    with pytest.raises(device.UnknownDevice):
        device.device_peaks()  # the CPU has no row


def test_profiler_prints_no_share_without_peaks():
    profiling.reset()
    profiling.enable()
    try:
        profiling.autoset_peaks()  # CPU: no row -> no peaks
        profiling.roofline("k", seconds=0.001, bytes_moved=10**6, flops=10**6)
        rep = profiling.report()
    finally:
        profiling.disable()
        profiling.reset()
    assert "GB/s" in rep and "% of peak" not in rep and "bound" not in rep
