"""Kernel autotuner: grid-search each kernel's free parameters per shape
bucket and backend (counterpart of ``repro/kernels/autotune.py``).

``kernels.ops`` resolves each entry point's parameters explicit -> tuned ->
default: an explicit kwarg wins, then the winner from the installed
``AutotuneCache`` for (kernel, backend, shape bucket), then the kernel's
own default. With no cache installed every lookup misses and nothing is
passed down, so the untuned path is bit-for-bit the historical one.

Backends: ``"ref"`` is the plain torch path (its rows copy the reference
package's ``"ref"`` rows), ``"cuda"`` the Hopper kernels in ``csrc/``, with
each kernel's own parameters. ``autotune()`` takes the backend explicitly:
it never picks the plain path because no card is present.

Caches are versioned JSON (the reference's format), keyed by
``kernel/backend/bucket``, stamped with the ``launch.envcfg`` fingerprint; a
cache recorded under another environment refuses to load
(``StaleCacheError``). The default root is ``build/repro_torch/autotune/``
at the repository root (git-ignored). The timer is
``kernels.timing.time_kernel``; tests inject deterministic fake timers.
"""
from __future__ import annotations

import itertools
import json
import math
import os
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

from repro_torch.core.pricing import KernelSample
from repro_torch.launch import envcfg

CACHE_VERSION = 1

CACHE_DIR = str(Path(__file__).resolve().parents[3] / "build" / "repro_torch"
                / "autotune")

# "paged_decode_quant" is the int8-KV paged decode read path: its tuning
# dimension is WHICH kernel runs (gather-dequantize then K2, or K4's fused
# int8 read), not a tile size.
KERNELS = ("flash_attention", "decode_attention", "paged_decode_quant",
           "ssm_scan")

BACKENDS = ("ref", "cuda")


class StaleCacheError(ValueError):
    """Cache recorded under a different environment fingerprint."""


# ------------------------------------------------------------- param spaces
# Defaults per (kernel, backend): what ops dispatch uses when no tuned entry
# matches. An empty dict means nothing to tune on that backend. The "ref"
# rows are the reference package's; the "cuda" rows are the Hopper
# kernels' own parameters and their wrappers' defaults. Flash tiles are the
# ones both of K1's kernels take (bf16 v3: one or two 64-row warpgroups;
# f32 v4: the same tiles), since a bucket does not say the dtype; K2's
# block_kv is the keys of one KV split.
DEFAULT_PARAMS: Dict[Tuple[str, str], Dict[str, object]] = {
    ("flash_attention", "ref"): {"block_q": 1024},
    ("flash_attention", "cuda"): {"block_q": 64, "block_kv": 64},
    ("decode_attention", "ref"): {},
    ("decode_attention", "cuda"): {"block_kv": 64},
    ("paged_decode_quant", "ref"): {"impl": "gather"},
    ("paged_decode_quant", "cuda"): {"impl": "gather"},
    ("ssm_scan", "ref"): {"chunk": 128},
    ("ssm_scan", "cuda"): {"chunk": 128},
}

# Candidate grids. Every space includes the default point, so the winner is
# never slower than the default on the measured grid.
_SPACES: Dict[Tuple[str, str], Dict[str, Sequence[object]]] = {
    ("flash_attention", "ref"): {"block_q": (128, 256, 512, 1024, 2048)},
    ("flash_attention", "cuda"): {"block_q": (64, 128),
                                  "block_kv": (32, 64, 128)},
    ("decode_attention", "ref"): {},
    ("decode_attention", "cuda"): {"block_kv": (32, 64, 128)},
    ("paged_decode_quant", "ref"): {"impl": ("gather", "fused")},
    ("paged_decode_quant", "cuda"): {"impl": ("gather", "fused")},
    ("ssm_scan", "ref"): {"chunk": (16, 32, 64, 128, 256)},
    ("ssm_scan", "cuda"): {"chunk": (32, 128)},
}


def default_params(kernel: str, backend: str) -> Dict[str, object]:
    """Default parameters for (kernel, backend)."""
    try:
        return dict(DEFAULT_PARAMS[(kernel, backend)])
    except KeyError:
        raise KeyError(f"unknown kernel/backend {(kernel, backend)!r}") from None


def param_space(kernel: str, backend: str) -> List[Dict[str, object]]:
    """Cartesian candidate grid (default point first)."""
    space = _SPACES.get((kernel, backend))
    if space is None:
        raise KeyError(f"unknown kernel/backend {(kernel, backend)!r}")
    if not space:
        return []
    names = sorted(space)
    combos = [dict(zip(names, vals))
              for vals in itertools.product(*(space[k] for k in names))]
    default = default_params(kernel, backend)
    combos.sort(key=lambda c: c != default)        # default first
    return combos


# ----------------------------------------------------------- shape buckets
def _pow2(x: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, int(x)))))


def shape_bucket(kernel: str, **dims: int) -> str:
    """Canonical bucket key for a kernel invocation's shape: sequence or
    context length and batch, each to the next power of two; head counts
    and head dim are left out.

      flash_attention    s=<seq>           -> "s1024"
      decode_attention   b=<batch> c=<ctx> -> "b8c2048"
      paged_decode_quant b=<batch> c=<ctx> -> "b8c1024"
      ssm_scan           s=<seq>           -> "s512"
    """
    if kernel in ("flash_attention", "ssm_scan"):
        return f"s{_pow2(dims['s'])}"
    if kernel in ("decode_attention", "paged_decode_quant"):
        return f"b{_pow2(dims['b'])}c{_pow2(dims['c'])}"
    raise KeyError(f"unknown kernel {kernel!r}")


# ------------------------------------------------------------------- cache
@dataclass(frozen=True)
class TunedEntry:
    """Winner of one (kernel, backend, shape-bucket) grid search, with the
    analytic work counts (flops/bytes/ctx) of the timed shape."""
    kernel: str
    backend: str
    bucket: str
    params: Dict[str, object]          # winning parameters
    t_s: float                         # winner best-of-k seconds
    t_default_s: float                 # default params, same sweep
    noise_frac: float                  # winner's (median-best)/best spread
    flops: float
    bytes: float
    ctx: float
    shape: Dict[str, int] = field(default_factory=dict)

    @property
    def speedup(self) -> float:
        return self.t_default_s / self.t_s

    def key(self) -> str:
        return cache_key(self.kernel, self.backend, self.bucket)


def cache_key(kernel: str, backend: str, bucket: str) -> str:
    return f"{kernel}/{backend}/{bucket}"


class AutotuneCache:
    """Tuned winners for one (profile, backend), stamped with the recording
    environment's fingerprint."""

    def __init__(self, profile: str, backend: str, *,
                 env: Optional[Dict[str, str]] = None,
                 entries: Iterable[TunedEntry] = ()):
        self.profile = profile
        self.backend = backend
        self.env = dict(env) if env is not None else envcfg.env_fingerprint()
        self.entries: Dict[str, TunedEntry] = {e.key(): e for e in entries}

    def add(self, entry: TunedEntry) -> None:
        self.entries[entry.key()] = entry

    def resolve(self, kernel: str, backend: str,
                bucket: str) -> Optional[Dict[str, object]]:
        """Winning params for (kernel, backend, bucket), or None."""
        e = self.entries.get(cache_key(kernel, backend, bucket))
        return dict(e.params) if e is not None else None

    def tuned_samples(self) -> List[KernelSample]:
        """The winners as ``KernelSample``s, the feed of a calibration fit."""
        return [KernelSample(e.kernel, e.flops, e.bytes, e.ctx, e.t_s,
                             noise_frac=e.noise_frac)
                for e in sorted(self.entries.values(), key=lambda e: e.key())]

    def geomean_speedup(self) -> float:
        """Geometric-mean tuned-vs-default speedup across entries."""
        ups = [e.speedup for e in self.entries.values()]
        if not ups:
            return 1.0
        return math.exp(sum(math.log(u) for u in ups) / len(ups))

    # ----------------------------------------------------------- artifacts
    def to_json(self) -> Dict[str, object]:
        return {
            "version": CACHE_VERSION,
            "profile": self.profile,
            "backend": self.backend,
            "env": self.env,
            "env_digest": envcfg.fingerprint_digest(self.env),
            "entries": {k: asdict(e) for k, e in sorted(self.entries.items())},
        }

    def dump(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def from_json(cls, data: Mapping[str, object], *,
                  require_env: bool = True) -> "AutotuneCache":
        version = data.get("version")
        if version != CACHE_VERSION:
            raise ValueError(f"autotune cache version {version!r} != "
                             f"supported {CACHE_VERSION}")
        env = dict(data["env"])                                # type: ignore[arg-type]
        recorded = data.get("env_digest")
        if recorded != envcfg.fingerprint_digest(env):
            raise ValueError("autotune cache corrupt: env_digest does not "
                             "match its recorded fingerprint")
        if require_env:
            current = envcfg.fingerprint_digest()
            if recorded != current:
                raise StaleCacheError(
                    f"autotune cache recorded under env {recorded} but the "
                    f"current env is {current}; re-run the autotuner "
                    "(or pass require_env=False to inspect it anyway)")
        entries = [TunedEntry(**e) for e in data["entries"].values()]  # type: ignore[union-attr]
        return cls(str(data["profile"]), str(data["backend"]), env=env,
                   entries=entries)

    @classmethod
    def load(cls, path: str, *, require_env: bool = True) -> "AutotuneCache":
        with open(path) as f:
            data = json.load(f)
        return cls.from_json(data, require_env=require_env)

    def __repr__(self) -> str:
        return (f"AutotuneCache(profile={self.profile!r}, "
                f"backend={self.backend!r}, entries={len(self.entries)})")


def cache_path(profile: str, backend: str, root: Optional[str] = None) -> str:
    """Canonical on-disk location for a (profile, backend) cache."""
    return os.path.join(root if root is not None else CACHE_DIR,
                        f"{profile}__{backend}.json")


# -------------------------------------------------------------- the tuner
# timer(kernel, shape, params=, backend=, iters=, seed=) -> KernelSample
Timer = Callable[..., KernelSample]

# Representative shapes per kernel (bucket-defining dims only; the timer
# fills in heads and head dim): the reference's grid.
DEFAULT_SHAPES: Dict[str, Tuple[Dict[str, int], ...]] = {
    "flash_attention": ({"s": 1024}, {"s": 2048}),
    "decode_attention": ({"b": 8, "c": 1024}, {"b": 8, "c": 4096}),
    "paged_decode_quant": ({"b": 8, "c": 1024}, {"b": 8, "c": 2048}),
    "ssm_scan": ({"s": 512}, {"s": 1024}),
}


def autotune(shapes: Optional[Mapping[str, Sequence[Dict[str, int]]]] = None,
             *, profile: str, backend: str, iters: int = 5, seed: int = 0,
             timer: Optional[Timer] = None,
             verbose: bool = False) -> AutotuneCache:
    """Grid-search every (kernel, shape) cell on ``backend`` ("ref" or
    "cuda") and return the winners. Each cell times every candidate in
    ``param_space`` best-of-k (warm-ups excluded) and keeps the fastest; the
    default is in every space, so a winner is never slower than the default
    on the measured grid."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if timer is None:
        from repro_torch.kernels.timing import time_kernel
        timer = time_kernel
    if shapes is None:
        shapes = DEFAULT_SHAPES

    cache = AutotuneCache(profile, backend)
    for kernel in sorted(shapes):
        if kernel not in KERNELS:
            raise KeyError(f"unknown kernel {kernel!r}; expected one of "
                           f"{KERNELS}")
        candidates = param_space(kernel, backend)
        if not candidates:
            continue                                 # nothing tunable here
        default = default_params(kernel, backend)
        for shape in shapes[kernel]:
            bucket = shape_bucket(kernel, **shape)
            best = None                              # (t_s, params, sample)
            t_default = None
            for params in candidates:
                sample = timer(kernel, dict(shape), params=params,
                               backend=backend, iters=iters, seed=seed)
                if params == default:
                    t_default = sample.t_s
                if best is None or sample.t_s < best[0]:
                    best = (sample.t_s, params, sample)
                if verbose:
                    print(f"[autotune] {kernel}/{bucket} {params} "
                          f"-> {sample.t_s * 1e3:.3f} ms")
            assert best is not None and t_default is not None
            t_s, params, sample = best
            cache.add(TunedEntry(
                kernel=kernel, backend=backend, bucket=bucket,
                params=dict(params), t_s=t_s, t_default_s=t_default,
                noise_frac=float(sample.noise_frac),
                flops=sample.flops, bytes=sample.bytes, ctx=sample.ctx,
                shape=dict(shape)))
            if verbose:
                print(f"[autotune] {kernel}/{bucket} winner {params} "
                      f"({t_default / t_s:.2f}x vs default)")
    return cache


# ----------------------------------------------- process-wide active cache
# The cache ``kernels.ops`` dispatch consults. Installing is explicit (no
# import-time disk reads). The lookup reads shapes only: it adds no host
# sync to a dispatch.
_ACTIVE: Optional[AutotuneCache] = None


def install(cache: Optional[AutotuneCache]) -> Optional[AutotuneCache]:
    """Make ``cache`` the process-wide tuned-params source (None clears).
    Returns the previously installed cache."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, cache
    return prev


def installed() -> Optional[AutotuneCache]:
    return _ACTIVE


def load_and_install(path: str, *, require_env: bool = True) -> AutotuneCache:
    cache = AutotuneCache.load(path, require_env=require_env)
    install(cache)
    return cache


def lookup(kernel: str, backend: str, bucket: str) -> Dict[str, object]:
    """Tuned params for a dispatch site ({} when none installed/matched)."""
    if _ACTIVE is None:
        return {}
    return _ACTIVE.resolve(kernel, backend, bucket) or {}
