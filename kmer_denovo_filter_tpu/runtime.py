"""Process set-up shared by the entry points: compile cache, cluster.

Importing this module touches no JAX backend, so the entry points can
call it before ``jax.distributed`` joins (the engine modules create
device constants at import, which would commit the backend first).
"""

import os

# Persistent compile cache inside the checkout (listed in .gitignore),
# used when JAX_COMPILATION_CACHE_DIR does not place it elsewhere.  A
# fixed path: the cache key includes it, so a moving directory never
# hits.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compile_cache():
    """Turn on JAX's persistent compile cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX
    reads it itself) and no other directory is set; otherwise the
    cache lands at :data:`DEFAULT_CACHE_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def distributed_config(environ=None):
    """``jax.distributed.initialize`` keyword arguments from the
    deployment environment, or None for a single-process run.

    ``KDF_COORDINATOR`` (host:port), ``KDF_NUM_PROCESSES`` and
    ``KDF_PROCESS_ID`` join the cluster; ``KDF_LOCAL_DEVICE_IDS``
    (comma-separated) restricts this process to its own devices —
    one process per GPU, so no two processes reserve one card.
    """
    env = os.environ if environ is None else environ
    coordinator = env.get("KDF_COORDINATOR")
    if not coordinator:
        return None
    ids = env.get("KDF_LOCAL_DEVICE_IDS")
    return {
        "coordinator_address": coordinator,
        "num_processes": int(env["KDF_NUM_PROCESSES"]),
        "process_id": int(env["KDF_PROCESS_ID"]),
        "local_device_ids": ([int(i) for i in ids.split(",")]
                             if ids else None),
    }


def require_gpu():
    """The JAX device report, or exit when JAX finds no GPU.

    Measurement entry points call this first: a number taken on
    another backend must never be reported as the card's.
    """
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {devices[0].platform!r}")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def gpu_name_power():
    """``name, power.limit`` of every card as nvidia-smi reports it
    (one line per card, joined by "; ")."""
    import subprocess

    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(line.strip() for line in res.stdout.splitlines()
                     if line.strip())
