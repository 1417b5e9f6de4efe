"""chip_smoke.py's phases at a tiny size, kernels in interpret mode on the
CPU, and its refusal to run without a GPU."""
import dataclasses
import json

import pytest

import chip_smoke
from gemma_tpu.models import GEMMA_2B
from gemma_tpu.testing import TINY_CONFIG

# wide enough that every matmul takes the kernel (K a superblock multiple)
SMALL = dataclasses.replace(
    TINY_CONFIG, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=256,
    n_layers=1,
)


def test_main_fails_without_a_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out  # no result line
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_main_four_fails_without_a_gpu(capsys):
    assert chip_smoke.main(["--four"]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_device_report_on_cpu():
    info = chip_smoke.device_report(require_gpu=False)
    assert info["platform"] == "cpu" and info["count"] >= 1
    with pytest.raises(chip_smoke.NoGPU):
        chip_smoke.device_report()


def test_projection_shapes():
    shapes = chip_smoke.projection_shapes(GEMMA_2B)
    assert shapes == {
        "qkv": (2560, 2048), "attn_out": (2048, 2048), "gate_up": (32768, 2048),
        "ffn_down": (2048, 16384), "lm_head": (256000, 2048),
    }


def test_kernel_phase_tiny(interpret_kernels):
    res = chip_smoke.kernel_phase(
        # at least two programs: XLA's CPU runtime cannot run the bf16 dot
        # of a kernel whose grid and loop both collapse to one step
        [("q4_0", 128, 512, 1), ("q4_k", 256, 256, 16), ("q6_k", 256, 256, 1),
         ("q8_0", 256, 256, 3)],
        [dict(S=128, Hq=4, Hkv=2, D=16, limits=[1, 100], mode=m)
         for m in ("bf16", "int8", "paged")]
        + [dict(S=128, Hq=4, Hkv=1, D=16, limits=[120], softcap=30.0,
                window=32, mode="paged", page_size=16, timing=True)],
        timing=False,
    )
    assert len(res) == 8 and all(r["ok"] for r in res)
    assert res[-1]["kernel_us"] > 0 and res[-1]["plain_us"] > 0


def test_kernel_phase_raises_on_a_miss(interpret_kernels, monkeypatch):
    monkeypatch.setattr(chip_smoke, "MATMUL_TOL", -1.0)
    with pytest.raises(AssertionError):
        chip_smoke.kernel_phase([("q4_0", 256, 256, 1)], [], timing=False)


def test_e2e_phase_tiny(interpret_kernels, capsys):
    chip_smoke.e2e_phase(SMALL, fmts=("q4_0",), max_seq_len=64, page_size=16,
                         n_requests=2, new_tokens=2)
    out = capsys.readouterr().out
    for cache in ("dense", "int8", "paged"):
        assert f"ok   serve q4_0 {cache}" in out
        assert f"verify q4_0 {cache}: kernel-vs-plain on-device verification: OK" in out
    assert "ok   KV hand-off over a socket" in out


def test_cli_and_memory_phases_tiny(interpret_kernels, tmp_path, capsys):
    chip_smoke.cli_phase(SMALL, str(tmp_path))
    res = chip_smoke.memory_phase(SMALL, new_tokens=2, max_seq_len=64)
    assert res["tok_per_s"] > 0
    out = capsys.readouterr().out
    assert "generate rc=0" in out and "memory_analysis" in out


def test_four_phase_on_virtual_devices(interpret_kernels, capsys):
    # d_ff 512: every shard-local kernel matmul keeps two programs or more
    chip_smoke.four_phase(dataclasses.replace(SMALL, d_ff=512), new_tokens=2)
    out = capsys.readouterr().out
    assert "ok   TPEngine matches one card" in out
    assert "ok   GSPMD shard_params matches one card" in out
    assert "ok   serve() over TPEngine" in out


def test_compare_streams_allows_only_near_ties():
    import numpy as np

    ref_t = np.array([[1, 2]])
    ref_l = np.zeros((1, 2, 4))
    ref_l[0, 0, 1] = 1.0
    ref_l[0, 1, 2], ref_l[0, 1, 3] = 1.0, 0.99
    chip_smoke.compare_streams("near tie", ref_t, ref_l, np.array([[1, 3]]), ref_l, 0.02)
    with pytest.raises(AssertionError):
        chip_smoke.compare_streams("far", ref_t, ref_l, np.array([[0, 2]]), ref_l, 0.02)
    with pytest.raises(AssertionError):
        chip_smoke.compare_streams("drift", ref_t, ref_l, ref_t, ref_l + 0.05, 0.02)
