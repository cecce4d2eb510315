"""Configuration layer: TOML settings file -> :class:`Settings`.

The same TOML schema as ``grayscott_jl_tpu/config/settings.py`` (one
positional CLI argument, strict ``.toml`` extension, unknown top-level
keys ignored, the ``[model]`` table validated loudly), resolved onto
PyTorch:

* ``backend``: ``"CUDA"`` / ``"GPU"`` select the card (the default),
  ``"CPU"`` the host. ``"TPU"`` / ``"AMDGPU"`` raise, naming what is
  accepted; a card that was asked for and is absent raises too
  (:func:`resolve_device`) — a run never drops to the CPU on its own.
* ``kernel_language``: ``"Pallas"`` / ``"Auto"`` / ``"CUDA"`` select the
  model's generated CUDA kernel (``ops/cuda_stencil.py``); ``"Plain"`` /
  ``"XLA"`` / ``"KernelAbstractions"`` select the plain torch path, and
  otherwise only ``"Auto"`` does, for a model the kernel generator
  refuses (``simulation.select_kernel``).
* ``precision``: ``Float32`` / ``Float64`` / ``BFloat16`` map to torch
  dtypes; ``compute_precision`` (``GS_COMPUTE_PRECISION``) picks the
  mixed-precision posture (:func:`resolve_compute_precision`).

Every key and ``GS_*`` variable the reference acts on is acted on here
too, or refused: a key whose subsystem is not in this package yet
raises :class:`SettingsError` when set to anything but the value that
means "off" (:data:`NOT_PORTED`), and so does an environment variable
that would turn such a subsystem on (:data:`NOT_PORTED_ENV`). Keys at
their defaults that the reference acts on — ``health_policy``,
``graceful_shutdown``, ``mesh_type``, ``reshard`` — are acted on
(``resilience/``, ``io/vtk.py``, :func:`resolve_reshard`), and so are
``GS_RESHARD_DEVICE`` (the live move's tier,
:func:`resolve_reshard_device`),
``comm_overlap`` / ``GS_COMM_OVERLAP`` (:func:`resolve_comm_overlap`)
and ``halo_depth`` / ``GS_HALO_DEPTH`` (:func:`resolve_halo_depth`),
the sharded round's exchange schedule, and the output and integrity
variables: ``GS_ASYNC_IO_DEPTH`` (the output
pipeline's depth, ``io/async_writer.resolve_depth``), ``GS_TPU_ADIOS2``
(``0`` keeps output stores on BP-lite where the adios2 bindings are
importable) and ``GS_TPU_NATIVE_IO`` (``0`` forces the Python store
engine), both in ``io/__init__.py``,
``GS_CKPT_REPLICAS``, ``GS_CKPT_VERIFY`` (``off``/``read``/``full``),
``GS_SCRUB`` and ``GS_SCRUB_EVERY`` (``resilience/integrity.py``), and
the launch variables of a run of several processes
(``GS_TPU_COORDINATOR`` with ``GS_TPU_NUM_PROCESSES`` and
``GS_TPU_PROCESS_ID``, or ``GS_TPU_DISTRIBUTED=auto`` with torchrun's
environment: :func:`resolve_launch`); their bad values raise at
start-up, as in the reference. So are ``compile_cache`` /
``GS_COMPILE_CACHE`` (:func:`resolve_compile_cache`: the directory the
kernels and the native store engine are built into and loaded from),
the observability sinks ``GS_EVENTS``, ``GS_METRICS`` (with
``metrics_interval_s`` / ``GS_METRICS_INTERVAL_S`` and
``GS_METRICS_PROM``) and ``GS_TRACE`` (with ``GS_TRACE_MAX_EVENTS``),
the numerics probes ``numerics`` / ``GS_NUMERICS`` with
``GS_NUMERICS_WINDOW``, ``GS_DRIFT_POLICY`` and ``GS_DRIFT_LIMIT``
(``obs/``, ``resilience/health.DriftGate``), the ``[ensemble]`` table
(``ensemble/spec.py``: presets, member tables, sweeps, ``seeds`` and
``member_shards``; the run is ``ensemble/engine.EnsembleSimulation``
with member-indexed stores, ``ensemble/io.py``) with
``GS_FAULT_MEMBER`` (the member the ``nan``, ``bitflip`` and ``sdc``
faults hit), and Auto's decision: the
fabric model's ``GS_AUTO_LINKS``, ``GS_AUTO_LINK_GBPS`` and
``GS_AUTO_OBJECTIVE`` (``parallel/icimodel.py``), and the measured
autotuner's ``autotune`` / ``GS_AUTOTUNE`` (:func:`resolve_autotune`)
with ``GS_AUTOTUNE_CACHE``, ``GS_AUTOTUNE_BUDGET_S``,
``GS_AUTOTUNE_STEPS``, ``GS_AUTOTUNE_ROUNDS`` and ``GS_AUTOTUNE_TOPN``
(``tune/``), and the rest of observability: ``xstats`` / ``GS_XSTATS``
(:func:`resolve_xstats`, build and launch analytics, ``obs/xstats.py``),
``GS_PROFILE`` with ``GS_PROFILE_DIR`` (a profiler window over a step
range, ``obs/trace.ProfileWindow``) and ``GS_TPU_PROFILE`` (a profiler
capture of the whole run, ``utils/profiler.trace``). Nothing is refused
any more: :data:`NOT_PORTED` and :data:`NOT_PORTED_ENV` are empty.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Dict, List, Tuple

import tomllib as _toml

from ..models.base import SettingsError


@dataclasses.dataclass
class Settings:
    """Simulation settings; the reference's keys and defaults, except
    ``backend`` (the card) and ``kernel_language`` (the kernel)."""

    L: int = 128
    steps: int = 20000
    plotgap: int = 200
    F: float = 0.04
    k: float = 0.0
    dt: float = 0.2
    Du: float = 0.05
    Dv: float = 0.1
    noise: float = 0.0
    output: str = dataclasses.field(
        default_factory=lambda: os.path.join(
            tempfile.gettempdir(), "gs_output.bp"
        )
    )
    checkpoint: bool = False
    checkpoint_freq: int = 2000
    checkpoint_output: str = "ckpt.bp"
    restart: bool = False
    restart_input: str = "ckpt.bp"
    #: Simulation step to restart from; -1 = the latest checkpoint.
    restart_step: int = -1
    mesh_type: str = "image"
    precision: str = "Float64"
    backend: str = "CUDA"
    kernel_language: str = "Auto"
    verbose: bool = False
    supervise: bool = False
    max_restarts: int = 3
    health_policy: str = "abort"
    faults: str = ""
    watchdog: str = "auto"
    watchdog_deadline_s: float = 0.0
    graceful_shutdown: bool = True
    comm_overlap: str = "auto"
    halo_depth: int = 0
    compile_cache: str = ""
    autotune: str = ""
    ensemble: Any = None
    reshard: str = "auto"
    metrics_interval_s: float = 0.0
    numerics: str = ""
    xstats: str = ""
    compute_precision: str = ""
    snapshot_bits: str = ""
    snapshot_bits_ckpt: bool = False
    model: str = "grayscott"
    model_params: Any = dataclasses.field(default_factory=dict)


SETTINGS_KEYS = frozenset(f.name for f in dataclasses.fields(Settings))

#: Keys whose subsystem this package does not have yet: each maps to
#: the values that mean "feature off" and the ROADMAP item that ports
#: it. Any other value raises at construction (:func:`check_ported`).
#: Every key the reference acts on is ported: the table is empty.
NOT_PORTED: Dict[str, Tuple[tuple, str]] = {}

PRECISIONS: Dict[str, str] = {
    "Float32": "float32",
    "Float64": "float64",
    "BFloat16": "bfloat16",
}

#: Valid mixed-precision compute postures: ``f32`` (the precision as
#: given), ``bf16_f32acc`` (a Float32 run with bfloat16 storage and
#: float32 accumulation) and ``equality`` (``f32`` that also refuses the
#: lossy snapshot codec).
COMPUTE_PRECISIONS = ("f32", "bf16_f32acc", "equality")

#: Backend strings -> torch device types.
BACKENDS: Dict[str, str] = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}

#: Kernel-language strings -> the port's two paths.
KERNEL_LANGUAGES: Dict[str, str] = {
    "plain": "plain",
    "xla": "plain",
    "kernelabstractions": "plain",
    "pallas": "cuda",
    "auto": "cuda",
    "cuda": "cuda",
}


def parse_cli_args(args: List[str]) -> str:
    """The config-file path: one required positional argument."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="gray-scott-torch",
        description="gray-scott simulation, PyTorch/CUDA version",
    )
    parser.add_argument("config_file", type=str, help="configuration file")
    return parser.parse_args(args).config_file


def parse_settings_toml(toml_contents: str) -> Settings:
    """Parse TOML text into :class:`Settings`; unknown keys are ignored."""
    config_dict = _toml.loads(toml_contents)
    settings = Settings()
    for key, value in config_dict.items():
        if key in SETTINGS_KEYS and key not in ("ensemble", "model",
                                                "model_params"):
            field_type = Settings.__dataclass_fields__[key].type
            setattr(settings, key, _coerce(key, value, field_type))
    mdl = config_dict.get("model")
    if mdl is not None:
        from ..models import get_model

        if isinstance(mdl, str):
            settings.model = mdl
        elif isinstance(mdl, dict):
            table = dict(mdl)
            settings.model = str(table.pop("name", settings.model))
            settings.model_params = table
        else:
            raise SettingsError(
                f"'model' must be a name string or a [model] table, "
                f"got {mdl!r}"
            )
        get_model(settings.model).validate_table(settings.model_params)
    # The [ensemble] table parses after the scalar and model keys, as in
    # the reference: member parameters default to the base values set
    # above and resolve against the selected model's declaration.
    ens = config_dict.get("ensemble")
    if ens is not None:
        from ..ensemble import spec as ensemble_spec

        settings.ensemble = ensemble_spec.from_toml(ens, settings)
    return settings


def _coerce(key: str, value: Any, field_type: str) -> Any:
    """Coerce a TOML value to the declared field type (int <-> float
    when exact); anything else is a config error."""
    if field_type == "float":
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"Setting {key!r} must be a number, got {value!r}")
        return float(value)
    if field_type == "int":
        if isinstance(value, float) and value.is_integer():
            value = int(value)
        if isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"Setting {key!r} must be an integer, got {value!r}")
        return value
    if field_type == "bool":
        if not isinstance(value, bool):
            raise ValueError(f"Setting {key!r} must be a boolean, got {value!r}")
        return value
    if field_type == "str":
        if not isinstance(value, str):
            raise ValueError(f"Setting {key!r} must be a string, got {value!r}")
        return value
    raise AssertionError(f"unhandled field type {field_type!r} for {key!r}")


def get_settings(args: List[str]) -> Settings:
    """CLI args -> Settings."""
    config_file = parse_cli_args(args)
    if not config_file.endswith(".toml"):
        ext = config_file.rsplit(".", 1)[-1]
        raise ValueError(
            "Config file must be in TOML format. "
            f"Extension not recognized: {ext}\n"
        )
    with open(config_file, "r", encoding="utf-8") as f:
        return parse_settings_toml(f.read())


def load_backend_and_lang(settings: Settings) -> Tuple[str, str]:
    """Normalized ``(device type, kernel path)``: ``("cuda"|"cpu",
    "cuda"|"plain")``; unsupported values raise naming the accepted
    ones."""
    b = settings.backend.lower()
    lang = settings.kernel_language.lower()
    if b not in BACKENDS:
        raise SettingsError(
            f"Unsupported backend: {settings.backend!r}. This package runs "
            f"on PyTorch; accepted: {sorted(BACKENDS)}"
        )
    if lang not in KERNEL_LANGUAGES:
        raise SettingsError(
            f"Unsupported kernel_language: {settings.kernel_language!r}. "
            f"Accepted: {sorted(KERNEL_LANGUAGES)}"
        )
    return BACKENDS[b], KERNEL_LANGUAGES[lang]


def resolve_device(settings: Settings):
    """The torch device the settings select. A card that was asked for
    and is not there is an error, never a quiet move to the CPU."""
    import torch

    kind, _ = load_backend_and_lang(settings)
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"backend = {settings.backend!r} selects the CUDA card, but "
            "torch.cuda.is_available() is False on this machine; set "
            "backend = \"CPU\" to run on the host"
        )
    return torch.device(kind)


def resolve_precision(settings: Settings):
    """Precision string -> torch dtype."""
    import torch

    name = PRECISIONS.get(settings.precision)
    if name is None:
        raise SettingsError(
            f"Unsupported precision: {settings.precision!r}. "
            f"Supported: {sorted(PRECISIONS)}"
        )
    return getattr(torch, name)


def resolve_compute_precision(settings: Settings) -> str:
    """The mixed-precision compute posture: ``"f32"``, ``"bf16_f32acc"``
    or ``"equality"``. ``GS_COMPUTE_PRECISION`` wins over the
    ``compute_precision`` key; unset is ``"f32"``. ``bf16_f32acc``
    requires ``precision = "Float32"`` (for Float64 it would quarter the
    mantissa silently, for BFloat16 it is the precision itself)."""
    raw = os.environ.get("GS_COMPUTE_PRECISION")
    if raw is None:
        raw = settings.compute_precision or ""
    v = raw.strip().lower() or "f32"
    v = {"float32": "f32", "fp32": "f32"}.get(v, v)
    if v not in COMPUTE_PRECISIONS:
        raise SettingsError(
            f"compute_precision / GS_COMPUTE_PRECISION must be one of "
            f"{'|'.join(COMPUTE_PRECISIONS)}, got {raw!r}"
        )
    if v == "bf16_f32acc" and settings.precision != "Float32":
        raise SettingsError(
            f"compute_precision = 'bf16_f32acc' requires precision = "
            f"'Float32' (got {settings.precision!r}): the posture is "
            "bf16 storage with f32 accumulation of an f32 run — use "
            "precision = 'BFloat16' for end-to-end bf16"
        )
    return v


#: Values of a boolean knob that mean "off".
_OFF = ("", "0", "off", "false", "no")

#: Environment variables the reference acts on whose subsystem is not
#: in this package yet: what they turn on, the values that mean "off",
#: and the ROADMAP item that ports it. Each changes what a run computes
#: or writes, so a value outside "off" raises at construction rather
#: than being ignored. Several override :data:`NOT_PORTED` keys.
NOT_PORTED_ENV: Dict[str, Tuple[str, tuple, str]] = {}

_TRUTHY = ("1", "on", "true", "yes")


def resolve_xstats(settings=None) -> bool:
    """Build and launch analytics (``obs/xstats.py``): ``GS_XSTATS``
    wins over the ``xstats`` key; default off. An unknown value raises
    ``ValueError`` at start-up, as in the reference."""
    raw = os.environ.get("GS_XSTATS")
    if raw is None and settings is not None:
        raw = getattr(settings, "xstats", "")
    raw = (raw or "").strip().lower()
    if raw in _TRUTHY:
        return True
    if raw in _OFF:
        return False
    raise ValueError(f"GS_XSTATS / xstats must be on or off, got {raw!r}")


def check_ported(settings: Settings) -> None:
    """Raise :class:`SettingsError` for any key set to a value whose
    subsystem is not in this package yet (:data:`NOT_PORTED`), and for
    any environment variable that turns such a subsystem on
    (:data:`NOT_PORTED_ENV`)."""
    for key, (off, item) in NOT_PORTED.items():
        value = getattr(settings, key)
        if isinstance(value, str):
            value = value.strip().lower()
        if value not in off:
            raise SettingsError(
                f"setting {key} = {getattr(settings, key)!r} is not "
                f"supported by grayscott_jl_tpu_torch yet (ROADMAP "
                f"{item}); remove it or use the default"
            )
    from .env import env_str

    for var, (what, off, item) in NOT_PORTED_ENV.items():
        value = env_str(var, "").strip().lower()
        if value not in off:
            raise SettingsError(
                f"{var}={value!r} asks for {what}, which "
                f"grayscott_jl_tpu_torch does not support yet (ROADMAP "
                f"{item}); unset it"
            )


@dataclasses.dataclass(frozen=True)
class Launch:
    """A multi-process launch read from the environment
    (:func:`resolve_launch`): this process's ``rank`` of ``world``, the
    ``host:port`` the processes meet at, and, when the launcher says,
    this process's rank among those of its host (``local_rank`` of
    ``local_world``)."""

    form: str  # "coordinator" (GS_TPU_*) or "torchrun"
    rank: int
    world: int
    host: str
    port: int
    local_rank: Any = None
    local_world: Any = None


def _launch_int(var: str, *, form: str, low: int, high=None) -> int:
    """A required integer launch variable in ``[low, high)``; missing or
    bad values raise naming it, as the reference's ``env_int`` does."""
    raw = os.environ.get(var)
    if raw is None or not raw.strip():
        raise SettingsError(f"{form} needs {var}, which is not set")
    try:
        v = int(raw)
    except ValueError as e:
        raise SettingsError(
            f"{var} must be an integer, got {raw!r}") from e
    if v < low or (high is not None and v >= high):
        bound = f"[{low}, {high})" if high is not None else f">= {low}"
        raise SettingsError(f"{var}={v} is outside {bound}")
    return v


def _host_port(var: str, value: str) -> Tuple[str, int]:
    host, sep, port = value.strip().rpartition(":")
    try:
        port_no = int(port)
    except ValueError:
        port_no = -1
    if not sep or not host or not 0 < port_no < 65536:
        raise SettingsError(f"{var} must be host:port, got {value!r}")
    return host, port_no


def _local(form: str, rank: int, world: int):
    """``(LOCAL_RANK, LOCAL_WORLD_SIZE)`` when both are set (torchrun and
    ``launch.py`` set them), else ``(None, None)``."""
    if (os.environ.get("LOCAL_RANK") is None
            and os.environ.get("LOCAL_WORLD_SIZE") is None):
        return None, None
    local_world = _launch_int("LOCAL_WORLD_SIZE", form=form, low=1,
                              high=world + 1)
    local_rank = _launch_int("LOCAL_RANK", form=form, low=0,
                             high=local_world)
    return local_rank, local_world


def resolve_launch():
    """The multi-process launch the environment asks for, or None (one
    process), in the reference's two forms (its
    ``maybe_initialize_distributed``):

    * ``GS_TPU_COORDINATOR=host:port`` with ``GS_TPU_NUM_PROCESSES`` and
      ``GS_TPU_PROCESS_ID``: the explicit launch (``launch.py``, or one
      command per host);
    * ``GS_TPU_DISTRIBUTED=auto``: the launcher's environment, here
      torchrun's (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
      ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), the
      counterpart of the pod autodetection.

    A missing or bad variable raises :class:`SettingsError` naming it."""
    coord = os.environ.get("GS_TPU_COORDINATOR", "").strip()
    if coord:
        form = "GS_TPU_COORDINATOR"
        host, port = _host_port(form, coord)
        world = _launch_int("GS_TPU_NUM_PROCESSES", form=form, low=1)
        rank = _launch_int("GS_TPU_PROCESS_ID", form=form, low=0,
                           high=world)
        return Launch("coordinator", rank, world, host, port,
                      *_local(form, rank, world))
    auto = os.environ.get("GS_TPU_DISTRIBUTED", "").strip().lower()
    if auto in _OFF:
        return None
    if auto != "auto":
        raise SettingsError(
            f"GS_TPU_DISTRIBUTED must be 'auto' or off, got {auto!r}")
    form = "GS_TPU_DISTRIBUTED=auto"
    missing = [v for v in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                           "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
               if not os.environ.get(v, "").strip()]
    if missing:
        raise SettingsError(
            f"{form} reads torchrun's environment, but "
            f"{', '.join(missing)} {'is' if len(missing) == 1 else 'are'} "
            "not set (start the run under torchrun, or set "
            "GS_TPU_COORDINATOR, GS_TPU_NUM_PROCESSES and "
            "GS_TPU_PROCESS_ID)")
    host = os.environ["MASTER_ADDR"].strip()
    _, port = _host_port("MASTER_ADDR:MASTER_PORT",
                         f"{host}:{os.environ['MASTER_PORT']}")
    world = _launch_int("WORLD_SIZE", form=form, low=1)
    rank = _launch_int("RANK", form=form, low=0, high=world)
    return Launch("torchrun", rank, world, host, port,
                  *_local(form, rank, world))


def resolve_comm_overlap(settings: Settings) -> str:
    """The split-phase exchange mode: ``"on"``, ``"off"`` or ``"auto"``
    (on for every sharded run). ``GS_COMM_OVERLAP`` wins over the
    ``comm_overlap`` key; any other value raises, with the reference's
    message."""
    raw = os.environ.get("GS_COMM_OVERLAP")
    if raw is None:
        raw = settings.comm_overlap or "auto"
    v = raw.strip().lower()
    v = {"1": "on", "true": "on", "yes": "on",
         "0": "off", "false": "off", "no": "off", "": "auto"}.get(v, v)
    if v not in ("on", "off", "auto"):
        raise ValueError(
            f"comm_overlap / GS_COMM_OVERLAP must be on/off/auto, "
            f"got {raw!r}"
        )
    return v


def resolve_halo_depth(settings: Settings) -> Tuple[bool, int]:
    """The s-step exchange depth ``(pinned, k)``, ``k >= 1``: one
    exchange round feeds ``k`` times the chain's depth.
    ``GS_HALO_DEPTH`` wins over the ``halo_depth`` key. ``0``,
    ``"auto"`` and unset resolve to ``(False, 1)``: not pinned, so the
    measured autotuner (``tune/``) searches k and may adopt a deeper one;
    an integer k >= 1 to ``(True, k)``. Bad values raise,
    with the reference's messages; whether the mesh's blocks can serve
    k is judged at construction (``Simulation``)."""
    raw = os.environ.get("GS_HALO_DEPTH")
    if raw is None:
        v = settings.halo_depth or 0
    else:
        r = raw.strip().lower()
        if r in ("", "auto"):
            v = 0
        else:
            try:
                v = int(r)
            except ValueError as e:
                raise ValueError(
                    f"GS_HALO_DEPTH must be an integer or 'auto', "
                    f"got {raw!r}"
                ) from e
    if v < 0:
        raise ValueError(
            f"halo_depth / GS_HALO_DEPTH must be >= 0 (0 = auto), "
            f"got {v}"
        )
    if v == 0:
        return False, 1
    return True, int(v)


#: Restore-time reshard modes: ``auto`` restores a checkpoint on any
#: block layout, ``off`` refuses a layout other than the checkpoint's.
RESHARD_MODES = ("auto", "off")


def resolve_reshard(settings: Settings) -> str:
    """The restore-time reshard mode, ``"auto"`` or ``"off"``:
    ``GS_RESHARD`` wins over the ``reshard`` key (booleans read as
    auto/off, as in the reference); any other value raises."""
    raw = os.environ.get("GS_RESHARD")
    if raw is None:
        raw = getattr(settings, "reshard", "auto") or "auto"
    v = raw.strip().lower()
    v = {"1": "auto", "true": "auto", "yes": "auto", "on": "auto",
         "0": "off", "false": "off", "no": "off", "": "auto"}.get(v, v)
    if v not in RESHARD_MODES:
        raise SettingsError(
            f"reshard / GS_RESHARD must be auto/off, got {raw!r}")
    return v


#: Live reshard tiers (``reshard/restore.device_all_to_all_restore``):
#: ``auto`` picks ``collective`` when both meshes span the same device
#: set and ``put`` across device sets; the named tiers pin one (a pinned
#: tier that cannot run raises); ``off`` refuses live moves (the
#: checkpoint restore stays available).
RESHARD_DEVICE_MODES = ("auto", "collective", "put", "host", "off")


def resolve_reshard_device(settings: "Settings | None" = None) -> str:
    """The live reshard tier: ``GS_RESHARD_DEVICE``, else a
    ``reshard_device`` attribute of the settings, else ``"auto"``; any
    other value raises, as in the reference."""
    raw = os.environ.get("GS_RESHARD_DEVICE")
    if raw is None:
        raw = getattr(settings, "reshard_device", "") or ""
    v = raw.strip().lower() or "auto"
    if v not in RESHARD_DEVICE_MODES:
        raise SettingsError(
            f"GS_RESHARD_DEVICE must be one of "
            f"{'/'.join(RESHARD_DEVICE_MODES)}, got {raw!r}")
    return v


#: Measured-autotuner modes, as in the reference (``tune/autotuner.py``).
AUTOTUNE_MODES = ("off", "cached", "quick", "full")


def resolve_autotune(settings: Settings) -> str:
    """The autotuner mode: ``GS_AUTOTUNE`` wins over the ``autotune``
    key; unset is ``cached``. Any other value raises, with the
    reference's message. Under ``kernel_language = "Auto"`` the tuner
    acts on it (``tune/autotuner.py``); a pinned language ignores it."""
    raw = os.environ.get("GS_AUTOTUNE")
    if raw is None:
        raw = getattr(settings, "autotune", "") or ""
    v = raw.strip().lower()
    if v == "":
        return "cached"
    if v not in AUTOTUNE_MODES:
        raise ValueError(
            f"autotune / GS_AUTOTUNE must be one of "
            f"{'|'.join(AUTOTUNE_MODES)}, got {raw!r}"
        )
    return v


def resolve_compile_cache(settings: Settings):
    """The build cache directory, or None: where the kernels
    (``ops/_build.py``) and the native store engine (``io/native.py``)
    are built at first use and loaded from (None: the package's own
    git-ignored build directories). ``GS_COMPILE_CACHE`` (a path, or
    ``off``/``0``/``false``/``no``) wins over the ``compile_cache`` key;
    a path is ``expanduser``-ed. Unset, it is on under supervision (a
    directory under ``~/.cache``), so that a restarted process reuses
    its builds, as in the reference, and off otherwise."""
    raw = os.environ.get("GS_COMPILE_CACHE")
    if raw is None:
        raw = settings.compile_cache or ""
    v = raw.strip()
    if v.lower() in ("off", "0", "false", "no"):
        return None
    if v:
        return os.path.expanduser(v)
    sup = os.environ.get("GS_SUPERVISE")
    if sup is not None:
        armed = sup.strip().lower() in ("1", "true", "yes", "on")
    else:
        armed = bool(settings.supervise)
    if armed:
        return os.path.join(os.path.expanduser("~"), ".cache",
                            "grayscott_jl_tpu_torch", "build")
    return None


def resolve_model(settings: Settings):
    """The registered model this config selects."""
    from ..models import get_model

    return get_model(settings.model or "grayscott")
