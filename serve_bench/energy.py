"""The card's energy over a window, measured.

First choice: NVML's total-energy counter (millijoules since the driver
loaded), ``nvmlDeviceGetTotalEnergyConsumption`` through ``ctypes`` on
``libnvidia-ml.so.1``, on the device whose UUID is torch's device 0.
Where the driver refuses that counter: ``nvidia-smi`` samples
``power.draw`` every 100 ms in a child process, and the samples are
integrated (trapezoids over their own timestamps).
"""
from __future__ import annotations

import ctypes
import subprocess
import time
from typing import List, Optional, Tuple


def _norm_uuid(u: str) -> str:
    u = u.strip().lower()
    return u[4:] if u.startswith("gpu-") else u


class _Nvml:
    def __init__(self, uuid: str):
        lib = ctypes.CDLL("libnvidia-ml.so.1")
        self._ok(lib.nvmlInit_v2(), "nvmlInit_v2")
        n = ctypes.c_uint()
        self._ok(lib.nvmlDeviceGetCount_v2(ctypes.byref(n)), "GetCount")
        want = _norm_uuid(uuid)
        self.handle = None
        seen = []
        for i in range(n.value):
            h = ctypes.c_void_p()
            self._ok(lib.nvmlDeviceGetHandleByIndex_v2(i, ctypes.byref(h)),
                     "GetHandleByIndex")
            buf = ctypes.create_string_buffer(96)
            self._ok(lib.nvmlDeviceGetUUID(h, buf, 96), "GetUUID")
            seen.append(buf.value.decode())
            if _norm_uuid(seen[-1]) == want:
                self.handle = h
        if self.handle is None:
            raise RuntimeError(f"no NVML device has torch's UUID {uuid} "
                               f"(NVML: {seen})")
        self.lib = lib
        self.read_mj()                        # refused here, if at all

    @staticmethod
    def _ok(code: int, what: str) -> None:
        if code != 0:
            raise RuntimeError(f"NVML {what} returned {code}")

    def read_mj(self) -> int:
        e = ctypes.c_ulonglong()
        self._ok(self.lib.nvmlDeviceGetTotalEnergyConsumption(
            self.handle, ctypes.byref(e)), "GetTotalEnergyConsumption")
        return e.value


class _SmiSampler:
    def __init__(self, uuid: str):
        self.uuid = uuid
        self.proc: Optional[subprocess.Popen] = None

    def start(self) -> None:
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--id={self.uuid}",
             "--query-gpu=timestamp,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> List[Tuple[float, float]]:
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=10)
        rows = []
        for line in out.splitlines():
            try:
                ts, w = line.split(",")
                t = time.mktime(time.strptime(ts.strip()[:19],
                                              "%Y/%m/%d %H:%M:%S"))
                frac = float("0." + ts.strip()[20:]) if "." in ts else 0.0
                rows.append((t + frac, float(w)))
            except ValueError:
                continue
        return rows


class EnergyMeter:
    """``start()`` and ``stop()`` bracket the window; ``joules`` and
    ``source`` after ``stop()``."""

    def __init__(self, uuid: str):
        self.source = "nvml_total_energy"
        self.note = ""
        self._t0: Optional[float] = None
        try:
            self._nvml: Optional[_Nvml] = _Nvml(uuid)
            self._smi = None
        except (OSError, RuntimeError, AttributeError) as e:
            self._nvml = None
            self._smi = _SmiSampler(uuid)
            self.source = "nvidia_smi_power_draw_100ms"
            self.note = f"NVML energy counter unavailable: {e}"
        self.joules: Optional[float] = None

    def start(self) -> None:
        if self._nvml is not None:
            self._e0 = self._nvml.read_mj()
        else:
            self._smi.start()
        self._t0 = time.time()

    def stop(self) -> float:
        t1 = time.time()
        if self._nvml is not None:
            self.joules = (self._nvml.read_mj() - self._e0) / 1e3
        else:
            rows = [r for r in self._smi.stop() if self._t0 <= r[0] <= t1]
            if len(rows) < 2:
                raise RuntimeError("nvidia-smi gave under two power samples "
                                   "in the window")
            self.joules = sum((b[0] - a[0]) * (a[1] + b[1]) / 2
                              for a, b in zip(rows, rows[1:]))
            self.joules *= (t1 - self._t0) / (rows[-1][0] - rows[0][0])
        return self.joules
