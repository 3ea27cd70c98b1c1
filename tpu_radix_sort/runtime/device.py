"""What a measurement needs to know about the device it ran on.

- :func:`require_gpu` refuses to measure anywhere but a GPU (a CPU run's
  times are not device times);
- :func:`card_lines` reads the card's name and power limit from
  `nvidia-smi` in a child process that stays off JAX;
- :func:`sort_lowerings` reads from optimized HLO which implementation
  each sort got: CUB's radix sort (a custom call) or XLA's own sort kernel;
- :data:`PEAK_HBM_BYTES_PER_S` holds the device-memory peaks that roofline
  shares are taken against, keyed by JAX's `device_kind`;
- :func:`enable_compile_cache` points JAX's persistent compile cache at
  `JAX_COMPILATION_CACHE_DIR` when set, else at one fixed directory in the
  checkout (listed in `.gitignore`).
"""
from __future__ import annotations

import os
import re
import subprocess

import jax

# NVIDIA data sheet, H100 SXM5 80 GB (HBM3). A device missing here is an
# error: a share against a guessed peak is not a measurement.
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

NVIDIA_SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader")

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_COMPILE_CACHE_DIR = os.path.join(_CHECKOUT, ".jax_cache")

# XLA's GPU sort rewriter names its CUB custom call "__cub$DeviceRadixSort"
_CUB_RE = re.compile(r'custom_call_target="[^"]*cub[^"]*"', re.IGNORECASE)
# an HLO sort instruction: "... = u32[n]{0} sort(" or "... = (...) sort("
_SORT_RE = re.compile(r"[)}]\s+sort\(")


class NoAcceleratorError(RuntimeError):
    """Raised when a device measurement is asked of a non-GPU platform."""


def require_gpu(platform: str | None = None) -> None:
    """Raise :class:`NoAcceleratorError` unless the platform is 'gpu'
    (default: the platform of `jax.devices()[0]`)."""
    if platform is None:
        platform = jax.devices()[0].platform
    if platform != "gpu":
        raise NoAcceleratorError(
            f"no GPU found: JAX's first device is on platform {platform!r}")


def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """`name, power.limit` CSV lines -> [(name, power_limit), ...]."""
    cards = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        name, sep, limit = line.rpartition(",")
        if not sep:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    return cards


def card_lines() -> list[str]:
    """The card query's output lines, verbatim; runs `nvidia-smi` as a
    child process so the query never touches JAX's hold on the card."""
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         check=True, timeout=60).stdout
    parse_nvidia_smi(out)  # validate the format
    return [line.strip() for line in out.splitlines() if line.strip()]


def sort_lowerings(hlo_text: str) -> dict[str, int]:
    """Count the sort implementations in optimized HLO text:
    {'cub': CUB radix-sort custom calls, 'xla': XLA sort instructions}."""
    return {
        "cub": len(_CUB_RE.findall(hlo_text)),
        "xla": len(_SORT_RE.findall(hlo_text)),
    }


def describe_lowering(hlo_text: str) -> str:
    """One word per sort kind present ('cub', 'xla-sort', both joined by
    '+'), or 'none' when the program has no sort."""
    counts = sort_lowerings(hlo_text)
    kinds = []
    if counts["cub"]:
        kinds.append(f"cub x{counts['cub']}")
    if counts["xla"]:
        kinds.append(f"xla-sort x{counts['xla']}")
    return "+".join(kinds) or "none"


def hbm_peak(device_kind: str) -> float:
    """Device-memory peak in bytes/s for a `device_kind` in the table."""
    try:
        return PEAK_HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(
            f"no memory-bandwidth peak on record for {device_kind!r}; add "
            "it to PEAK_HBM_BYTES_PER_S with its source") from None


def compile_cache_dir(environ=os.environ) -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else the checkout's fixed
    `.jax_cache` directory."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_COMPILE_CACHE_DIR


def enable_compile_cache(environ=os.environ) -> str:
    """Turn on JAX's persistent compile cache for an entry point.

    When `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and
    nothing is changed; otherwise the cache directory is set to the
    checkout's `.jax_cache`. Returns the directory in use.
    """
    path = compile_cache_dir(environ)
    if not environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
