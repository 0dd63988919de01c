"""Device batch configuration (the --gpu-cfg JSON analog).

The reference tunes its GPU path per device with JSON configs
(gpu/*.json, parsed at plmem.cu:373-451): stream counts, batch anchor
caps, grid/block dims and segment-size cutoffs.  Here the kernel's
geometry follows from the batch itself (ops/chain_device), so the JSON
sets only the macro-batch caps.  Absent fields keep defaults, like
cJSON's optional lookups.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass


@dataclass
class DeviceConfig:
    # macro-batch caps (max_total_n / max_read analogs, plmem.cu:473-540)
    # consumed by models.pipeline._acc_batches; a batch is cut (and the
    # overflow read spilled to the next one, map.c:886-922) when either
    # cap would be exceeded
    max_anchors_batch: int = 1_000_000
    max_reads_batch: int = 200_000
    # True when the JSON set the caps explicitly — the auto capacity
    # model (derive_caps) then leaves them alone, mirroring the
    # reference's config-overrides-model tiering (plmem.cu:473-540)
    caps_explicit: bool = False


_current = DeviceConfig()


def current_config() -> DeviceConfig:
    """The active config (set by apply_device_config; defaults otherwise)."""
    return _current


def load_device_config(path: str | None) -> DeviceConfig:
    cfg = DeviceConfig()
    if not path:
        return cfg
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        sys.stderr.write(f"[W::devcfg] cannot read {path}: {e}; "
                         "using defaults\n")
        return cfg
    for k in ("max_anchors_batch", "max_reads_batch"):
        if k in data:
            setattr(cfg, k, int(data[k]))
            cfg.caps_explicit = True
    return cfg


# Bytes of device memory per batched anchor, per in-flight macro-batch
# (ops/chain_device.dispatch_scores): the int32 operand rows x, y, range
# (12 B) and the int32 results f, p (8 B), each padded by _quant_size
# (<= 1.25x) -> 25 B.  x2 for the double-buffered pipeline (batch N
# scores on the device while batch N-1 drains on the host).  The
# reference derives its max_total_n/max_read the same way from its SoA
# footprint (plmem.cu:473-540, factors F1..F4).
BYTES_PER_ANCHOR = 2 * 25
MEM_FRACTION = 0.5          # leave headroom for XLA scratch + compiles
AVG_ANCHORS_PER_READ = 1000  # reference's max_read = max_total_n / 1000
# Ceiling on the auto-derived anchor cap.  Memory is never the limit on a
# large card; the pipeline is: a run must split into several batches for
# host seeding, device scoring and host finishing to overlap
# (models/pipeline.map_file_device_records), and one giant batch would
# serialize them.
MAX_AUTO_ANCHORS = 2_000_000


def derive_caps(verbose: int = 1) -> None:
    """Auto capacity model: scale the macro-batch caps to the attached
    device's memory when the config didn't pin them (plmem_config_batch
    analog).  No-op on CPU backends or when the device can't report its
    memory; never lowers caps below the shipped defaults."""
    cfg = _current
    if cfg.caps_explicit:
        return
    import jax
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return
    limit = int((dev.memory_stats() or {}).get("bytes_limit", 0))
    if limit <= 0:
        return
    anchors = min(int(limit * MEM_FRACTION / BYTES_PER_ANCHOR),
                  MAX_AUTO_ANCHORS)
    if anchors <= cfg.max_anchors_batch:
        return
    cfg.max_anchors_batch = anchors
    cfg.max_reads_batch = max(cfg.max_reads_batch,
                              anchors // AVG_ANCHORS_PER_READ)
    if verbose >= 3:
        sys.stderr.write(
            f"[M::devcfg] auto capacity: {limit / 2**30:.1f} GiB device "
            f"memory x {MEM_FRACTION} / {BYTES_PER_ANCHOR} B/anchor -> "
            f"max_anchors_batch {anchors}, max_reads_batch "
            f"{cfg.max_reads_batch}\n")


def apply_device_config(cfg: DeviceConfig) -> None:
    """Install the config into the batcher."""
    global _current
    _current = cfg


def compile_cache_dir() -> str:
    """Where JAX keeps compiled kernels across processes: the directory
    JAX_COMPILATION_CACHE_DIR names, else a fixed directory in the
    checkout (the path is part of the cache key, so it must not move)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache")


def enable_compile_cache() -> str:
    """Persistent XLA compilation cache, so fresh CLI processes reuse the
    compiled chain kernel.  JAX reads JAX_COMPILATION_CACHE_DIR itself;
    only without it is a directory set here.  Returns the directory."""
    import jax
    loc = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(loc, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", loc)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return loc
