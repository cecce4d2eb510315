"""grayscott_jl_tpu_torch — the Gray-Scott reaction-diffusion framework
on PyTorch and CUDA (NVIDIA Hopper).

The counterpart of ``grayscott_jl_tpu`` (the JAX/Pallas reference, kept
beside it): the same TOML settings, models, position-keyed noise, BP-lite
stores and checkpoints, with the fused stencil chain as a hand-written
CUDA template (``ops/csrc/stencil_chain.cu``) into which the kernel
generator (``ops/kernelgen.py``) emits each model's reaction. It imports
neither JAX nor the reference package. Entry points run on the CUDA
card unless the settings ask for ``backend = "CPU"``.

    from grayscott_jl_tpu_torch import main, initialization, Simulation, Settings
"""

from .config.settings import (  # noqa: F401
    Settings,
    get_settings,
    load_backend_and_lang,
    parse_settings_toml,
    resolve_precision,
)
from .simulation import Simulation, initialization  # noqa: F401

__version__ = "0.1.0"


def main(args, *, n_devices=None):
    """CLI driver entry point."""
    from .driver import main as _main

    return _main(args, n_devices=n_devices)


def julia_main(args=None, *, n_devices=None) -> int:
    """Exit-code wrapper: 0 on success; after a SIGTERM/SIGINT that the
    run turned into a boundary checkpoint (``GracefulShutdown``),
    ``EXIT_PREEMPTED`` (75) so that a relauncher resumes it; 1 on any
    other failure (with the traceback on stderr). The hang watchdog's
    hard exit leaves the process with ``EXIT_HANG`` (76) from its own
    thread. After 75 or 76 a supervised relaunch (``GS_SUPERVISE=1``)
    resumes by itself from the journal's marker (``GS_FAULT_JOURNAL``,
    default ``<output>.faults.jsonl``). ``n_devices`` is the number of
    blocks (of this process, in a multi-process run)."""
    import sys
    import traceback

    from .resilience.faults import EXIT_PREEMPTED, GracefulShutdown

    try:
        main(sys.argv[1:] if args is None else args, n_devices=n_devices)
    except GracefulShutdown as e:
        print(f"gray-scott-torch: {e}; exiting {EXIT_PREEMPTED} (rerun "
              "under GS_SUPERVISE=1 to auto-resume)", file=sys.stderr)
        return EXIT_PREEMPTED
    except Exception:  # noqa: BLE001 — the exit code is the product
        traceback.print_exc()
        return 1
    return 0


def cli_main() -> None:
    """``gray-scott-torch`` console-script entry point."""
    import sys
    import time

    t0 = time.perf_counter()
    rc = julia_main(sys.argv[1:])
    if rc == 0:
        print(f"{time.perf_counter() - t0:.6f} seconds", file=sys.stderr)
    sys.exit(rc)
