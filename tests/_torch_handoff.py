"""Fixtures shared by the port's KV-handoff tests (tests/test_torch_disagg.py
on the CPU, tests/test_torch_gpu.py on the card). Imports no JAX, so the
card's tests can use it on a machine that has only torch."""
import torch


def probe_pair(SP):
    """The probe pair of tests/test_disagg.py as ``SP`` (the JAX package's
    or the port's ``SystemProfile``): a slow, near-dark eff pool and a fast,
    high-idle perf pool joined by a 400 Gb/s link."""
    eff = SP(name="eff", kind="eff", chips=1, peak_flops=5e12,
             hbm_bw=0.8e12, ici_bw=50e9, power_peak_w=120.0,
             power_idle_w=8.0, overhead_s=0.02, sat_ctx=2048.0,
             link_bw_gbps=400.0)
    perf = SP(name="perf", kind="perf", chips=4, peak_flops=400e12,
              hbm_bw=1.25e12, ici_bw=100e9, power_peak_w=350.0,
              power_idle_w=100.0, overhead_s=0.0005, link_bw_gbps=400.0)
    return eff, perf


def kv_pools(gen, kind, shape, device):
    """A paged cache's pools of ``shape`` (layers, blocks, Hkv, bs, D) with
    random contents: bf16 or float32, or int8 with float32 scale pools in
    [0.005, 0.02)."""
    if kind != "int8":
        dt = getattr(torch, kind)
        return {k: torch.randn(shape, generator=gen, device=device).to(dt)
                for k in ("kp", "vp")}
    out = {k: torch.randint(-127, 128, shape, generator=gen,
                            device=device).to(torch.int8)
           for k in ("kp", "vp")}
    for k in ("kp_scale", "vp_scale"):
        out[k] = torch.rand(shape[:-1] + (1,), generator=gen,
                            device=device) * 0.015 + 0.005
    return out
