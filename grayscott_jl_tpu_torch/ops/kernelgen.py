"""Kernel generator: the fused CUDA stencil kernel from a model's
declaration (counterpart of ``grayscott_jl_tpu/ops/kernelgen.py``).

Any registered model (``models/base.Model``) whose pure ``reaction``
traces to elementwise torch gets the fused stencil + reaction + noise
kernel ``ops/csrc/stencil_chain.cu``: n fields, per-field frozen-ghost
boundary values, a params vector, the in-kernel temporal chain and the
three face modes. The template carries everything but the reaction;
this module emits the reaction into it:

1. **Trace.** The reaction runs once on (4, 4, 4) dummies under a
   ``TorchFunctionMode`` that records every torch call with its
   operands. The recording is a straight-line SSA program
   (:class:`Program`): one op per torch call, in the order the reaction
   made them, each operand a field value, a Laplacian, the pre-scaled
   noise, a parameter, a constant or an earlier op. The program is
   traced once per dtype, so a constant such as FHN's
   ``v.new_tensor(1/3)`` holds the value the reaction computes at that
   dtype. bfloat16 fields run the float32 program (:data:`DTYPES`): the
   kernel computes them in float32, as the reference traces the
   reaction on its float32 compute values, so there FHN's constant is
   the float32 1/3 (the bf16 one only on the Plain language's bf16
   path).
2. **Gate.** :func:`generation_gate_reason` refuses a reaction that
   fails to trace, returns the wrong number or shape of derivatives, or
   calls a torch op outside the elementwise whitelist — the reference's
   four reason classes, in its wording. The whitelist is conservative:
   arithmetic, a few math functions, constants and identities. An op
   that couples cells (a reduction, an index, a shape read) cannot be
   inlined, because a kernel thread only sees its own cell's values.
3. **Emit.** :func:`emit_reaction` writes the program as a C++
   ``__device__`` function ``gs_reaction`` over ``NF`` field values,
   ``NF`` Laplacians, the noise and the params array, one statement per
   op, in trace order. Sums, differences, products and quotients are
   the explicitly rounded intrinsics of the template (``__f*_rn`` /
   ``__d*_rn``, built with ``--fmad=false``) and constants are exact
   hex-float literals of the dtype, so the kernel performs the IEEE
   operations torch performs and equals the plain torch version
   bitwise. Where torch's CUDA kernel for an op is not that single
   operation, the emitter writes what the CUDA kernel does: a quotient
   by a Python scalar is a product with the reciprocal rounded once on
   the host, ``x ** 2`` and ``x ** 3`` are products, ``c / x`` is
   ``(1 / x) * c``, ``sigmoid`` is ``1 / (1 + exp(-x))``. The math
   functions (``exp``, ``tanh``, ``log``, ...) call CUDA's math library,
   whose results need not equal torch's bit for bit:
   :attr:`Program.exact` is False for a program that uses one, and the
   card tests hold such a kernel at a stated tolerance instead.

The four registered models use only ``+``, ``-`` and ``*``: their
kernels are bitwise equal to their plain versions, Gray-Scott's
included — its hand-written device reaction is gone, as the reference
removed its hand kernel.

:class:`KernelSpec` is the generator's contract with the dispatch
(``ops/cuda_stencil.py``) and the build (``ops/_build.py``, one library
per spec, named by a hash of the template and the emitted text). Specs
are memoized per model object (:func:`get_spec`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

#: Version of the generated-kernel contract; bump when the emitted
#: program changes in any observable way (operation order, constants,
#: what an op lowers to).
GENERATOR_VERSION = 1

#: Shape of the dummies the reaction is traced over (the reference's).
TRACE_SHAPE = (4, 4, 4)

#: Dtypes a program is emitted for, with their C++ type names; bfloat16
#: fields compute with the float32 program.
DTYPES = {"float32": "float", "float64": "double"}

#: torch op (as ``__torch_function__`` sees it, dunders stripped; an
#: in-place op keeps its trailing underscore and is refused) ->
#: (program op, operands swapped). Binary arithmetic.
_BINARY = {
    "add": ("add", False), "radd": ("add", True),
    "sub": ("sub", False), "rsub": ("sub", True),
    "subtract": ("sub", False),
    "mul": ("mul", False), "rmul": ("mul", True),
    "multiply": ("mul", False),
    "div": ("div", False), "truediv": ("div", False),
    "true_divide": ("div", False), "divide": ("div", False),
    "rtruediv": ("rdiv", False), "rdiv": ("rdiv", False),
    "pow": ("pow", False), "rpow": ("pow", True),
    "maximum": ("maximum", False), "minimum": ("minimum", False),
}

#: Unary elementwise ops -> program op.
_UNARY = {
    "neg": "neg", "negative": "neg", "abs": "abs", "absolute": "abs",
    "square": "square", "sqrt": "sqrt", "rsqrt": "rsqrt",
    "reciprocal": "reciprocal", "exp": "exp", "expm1": "expm1",
    "log": "log", "log1p": "log1p", "sigmoid": "sigmoid",
    "tanh": "tanh", "sin": "sin", "cos": "cos",
    "pos": "copy", "positive": "copy", "clone": "copy",
    "contiguous": "copy", "to": "copy",
}

#: Ops that make a constant tensor (every element the same value).
_CONSTANT = frozenset({
    "new_tensor", "tensor", "scalar_tensor", "as_tensor", "new_full",
    "full_like", "zeros_like", "ones_like",
})

#: Tensor attributes a reaction may read: none of them depends on the
#: window's shape, which differs between the trace and the kernel.
_METADATA = frozenset({
    "dtype", "device", "is_cuda", "layout", "requires_grad", "ndim",
    "dim",
})

#: Keyword arguments an op may carry, with the values that keep it the
#: plain elementwise op (``None`` = any value).
_KWARGS = {
    "alpha": (1,), "rounding_mode": (None,), "dtype": None,
    "device": None, "requires_grad": (False,), "non_blocking": None,
    "copy": None, "memory_format": None,
}

#: Program ops lowered through CUDA's math library (not bitwise).
LIBM_OPS = frozenset({
    "exp", "expm1", "log", "log1p", "tanh", "sin", "cos", "rsqrt",
    "sigmoid",
})


class KernelGenError(ValueError):
    """A model declaration the generator cannot lower; ``str(exc)``
    holds the feasibility reason recorded in ``kernel_gate``
    provenance."""


#: An operand of a program op: ``("field", i)``, ``("lap", i)``,
#: ``("noise",)``, ``("param", j)`` (index into the params vector),
#: ``("scalar", x)`` (a Python number, or a 0-dim CPU tensor: a CPU
#: scalar on the card), ``("const", x)`` (a constant tensor made on
#: the fields' device) or ``("t", k)`` (the result of op k).
Ref = Tuple


@dataclasses.dataclass(frozen=True)
class Program:
    """The traced reaction at one dtype: straight-line SSA ops (op
    ``k`` defines ``t{k}``) and one output operand per field."""

    dtype: str
    ops: Tuple[Tuple[str, Tuple[Ref, ...]], ...]
    outputs: Tuple[Ref, ...]

    @property
    def exact(self) -> bool:
        """True when every op lowers to correctly rounded arithmetic,
        so the kernel equals the plain torch version bitwise."""
        for name, args in self.ops:
            if name in LIBM_OPS:
                return False
            if name == "pow" and _pow_exponent(args) not in (2, 3, 0.5):
                return False
        return True

    @property
    def n_operations(self) -> int:
        """Floating-point operations per cell: the program's length,
        identities and constants excluded (a math function counts
        once)."""
        return sum(1 for name, _ in self.ops if name != "copy")


@dataclasses.dataclass(frozen=True, eq=False)
class KernelSpec:
    """Static view of a Model declaration for the generated kernel:
    the declaration, the traced program per dtype, and the C++ text of
    the generated part of the kernel (``cuda_source``, inserted into
    ``ops/csrc/stencil_chain.cu``). Identity-hashed and memoized per
    model object (:func:`get_spec`)."""

    name: str
    n_fields: int
    field_names: Tuple[str, ...]
    boundaries: Tuple[float, ...]
    param_fields: Tuple[str, ...]
    params_cls: type
    reaction: Callable
    model: object
    programs: Dict[str, Program]
    cuda_source: str
    version: int = GENERATOR_VERSION

    def flops_per_cell_step(self, dtype: str = "float32") -> int:
        """Floating-point operations of one cell and step: per field the
        Laplacian (5 sums, a product, a difference) and the Euler update
        (a product and a sum), the noise's scaling (``u * 2 - 3`` and
        ``noise *``), and the reaction's own program."""
        return (9 * self.n_fields + 3
                + self.programs[dtype].n_operations)


def _pow_exponent(args):
    """The exponent of a ``pow`` op when it is a Python scalar, else
    None."""
    ref = args[1]
    return ref[1] if ref[0] == "scalar" else None


def _op_name(func) -> str:
    """The torch name of a recorded call, dunders stripped; a property
    read is named after the property."""
    name = getattr(func, "__name__", None) or repr(func)
    if name == "__get__":
        owner = getattr(func, "__self__", None)
        name = getattr(owner, "__name__", name)
    if len(name) > 4 and name.startswith("__") and name.endswith("__"):
        name = name[2:-2]
    return name


def _trace(model, dtype: str):
    """``(program, None)`` for ``model``'s reaction traced at ``dtype``,
    or ``(None, reason)`` when the generator cannot lower it."""
    import torch
    from torch.overrides import TorchFunctionMode

    tdtype = getattr(torch, dtype)
    n = len(model.field_names)
    gen = torch.Generator().manual_seed(0)

    def dummy(shape=TRACE_SHAPE):
        return torch.rand(shape, generator=gen, dtype=tdtype) + 0.5

    fields = tuple(dummy() for _ in range(n))
    laps = tuple(dummy() for _ in range(n))
    noise = dummy()
    params = model.params_cls(*(dummy(()) for _ in model.params_cls._fields))
    refs: Dict[int, Ref] = {}
    for i, t in enumerate(fields):
        refs[id(t)] = ("field", i)
    for i, t in enumerate(laps):
        refs[id(t)] = ("lap", i)
    refs[id(noise)] = ("noise",)
    for j, t in enumerate(params):
        refs[id(t)] = ("param", j)
    keep: List[object] = [fields, laps, noise, params]
    ops: List[Tuple[str, Tuple[Ref, ...]]] = []
    bad = set()

    def constant(t) -> Optional[float]:
        """The one value of a constant tensor, or None."""
        flat = t.detach().reshape(-1)
        if flat.numel() == 0 or not bool((flat == flat[0]).all()):
            return None
        return float(flat[0])

    def operand(x) -> Optional[Ref]:
        if isinstance(x, torch.Tensor):
            ref = refs.get(id(x))
            if ref is not None:
                return ref
            # A tensor the reaction captured: only a 0-dim CPU constant
            # (a CPU scalar on the card) can be inlined.
            if x.dim() == 0 and x.device.type == "cpu":
                return ("scalar", float(x))
            return None
        if isinstance(x, (bool, int, float)):
            return ("scalar", float(x))
        return None

    def record(name, args, kwargs, out):
        for key, value in kwargs.items():
            allowed = _KWARGS.get(key, ())
            if allowed is not None and value not in allowed:
                bad.add(f"{name}({key}={value!r})")
                return
        if not isinstance(out, torch.Tensor):
            if name not in _METADATA:
                bad.add(name)
            return
        keep.append(out)
        if name in _CONSTANT:
            value = constant(out)
            if value is None:
                bad.add(name)
                return
            # torch.tensor(x) without a device is a CPU tensor: on the
            # card it is a CPU scalar, like a Python number.
            on_host = name in ("tensor", "scalar_tensor", "as_tensor")
            refs[id(out)] = ("scalar" if on_host and "device" not in kwargs
                             else "const", value)
            return
        if out.dtype != tdtype:
            bad.add(f"{name}->{out.dtype}")
            return
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if name in _UNARY:
            if not tensors:
                bad.add(name)
                return
            operands = (operand(tensors[0]),)
            op = _UNARY[name]
        elif name in _BINARY and len(args) == 2:
            operands = (operand(args[0]), operand(args[1]))
            op, swapped = _BINARY[name]
            if swapped:
                operands = operands[::-1]
        else:
            bad.add(name)
            return
        if any(r is None for r in operands):
            bad.add(name)
            return
        refs[id(out)] = ("t", len(ops))
        ops.append((op, operands))

    class Recorder(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            record(_op_name(func), args, kwargs, out)
            return out

    try:
        with Recorder():
            derivs = model.reaction(fields, laps, noise, params)
    except Exception as e:  # noqa: BLE001 — the reason IS the product
        return None, f"reaction failed to trace: {type(e).__name__}: {e}"
    if not isinstance(derivs, (tuple, list)) or len(derivs) != n:
        got = len(derivs) if isinstance(derivs, (tuple, list)) else 1
        return None, f"reaction returned {got} derivative(s) for {n} field(s)"
    outputs = []
    for fname, d in zip(model.field_names, derivs):
        shape = tuple(d.shape) if isinstance(d, torch.Tensor) else ()
        if shape != TRACE_SHAPE:
            return None, (
                f"derivative for field {fname!r} has shape {shape}, "
                f"expected the field shape {TRACE_SHAPE}"
            )
        outputs.append(refs.get(id(d)))
    if any(r is None for r in outputs) and not bad:
        bad.add("untraced derivative")
    if bad:
        return None, (
            "reaction uses non-elementwise primitive(s) "
            f"{sorted(bad)}; the slab pipeline only sees a local "
            "window, so cross-cell ops cannot be inlined"
        )
    return Program(dtype=dtype, ops=tuple(ops), outputs=tuple(outputs)), None


def generation_gate_reason(model) -> Optional[str]:
    """Why the generator cannot lower ``model``'s reaction into the
    fused kernel, or ``None`` when it can: the reaction traced over
    float32 dummies (the reference's gate). Touches no device."""
    return _trace(model, "float32")[1]


# ---------------------------------------------------------------- emitter

def literal(value: float, dtype: str) -> str:
    """``value`` rounded to ``dtype`` as an exact C++ hex-float literal
    (a bit pattern for inf and NaN)."""
    import numpy as np

    if dtype == "float32":
        v = np.float32(value)
        if not math.isfinite(v):
            bits = int(np.array(v).view(np.uint32))
            return f"__int_as_float(0x{bits:08X})"
        return f"{float(v).hex()}f"
    v = float(value)
    if not math.isfinite(v):
        bits = int(np.array(v).view(np.uint64))
        return f"__longlong_as_double(0x{bits:016X}LL)"
    return v.hex()


def _reciprocal(value: float, dtype: str) -> float:
    """``1 / value`` rounded once at ``dtype``: what torch's CUDA
    division by a CPU scalar multiplies with."""
    import numpy as np

    if dtype == "float32":
        with np.errstate(divide="ignore"):
            return float(np.float32(1.0) / np.float32(value))
    return 1.0 / value if value != 0 else math.copysign(math.inf, value)


#: Math-library functions per dtype.
_LIBM = {
    "exp": ("expf", "exp"), "expm1": ("expm1f", "expm1"),
    "log": ("logf", "log"), "log1p": ("log1pf", "log1p"),
    "tanh": ("tanhf", "tanh"), "sin": ("sinf", "sin"),
    "cos": ("cosf", "cos"), "rsqrt": ("rsqrtf", "rsqrt"),
    "pow": ("powf", "pow"),
}


def _expression(name, args, ref, dtype):
    """The C++ expression of one program op."""
    libm = _LIBM.get(name, ("", ""))[0 if dtype == "float32" else 1]
    one = literal(1.0, dtype)
    a = ref(args[0])
    if name in ("add", "sub", "mul"):
        return f"{name}({a}, {ref(args[1])})"
    if name == "div":
        if args[1][0] == "scalar":
            inv = literal(_reciprocal(args[1][1], dtype), dtype)
            return f"mul({a}, {inv})"
        return f"div({a}, {ref(args[1])})"
    if name == "rdiv":
        return f"mul(div({one}, {a}), {ref(args[1])})"
    if name == "neg":
        return f"(-{a})"
    if name == "abs":
        return f"fabs({a})"
    if name == "square":
        return f"mul({a}, {a})"
    if name == "sqrt":
        return f"sqrt_rn({a})"
    if name == "reciprocal":
        return f"div({one}, {a})"
    if name == "copy":
        return a
    if name == "sigmoid":
        exp = _LIBM["exp"][0 if dtype == "float32" else 1]
        return f"div({one}, add({one}, {exp}(-{a})))"
    if name == "pow":
        e = _pow_exponent(args)
        if e == 2:
            return f"mul({a}, {a})"
        if e == 3:
            return f"mul(mul({a}, {a}), {a})"
        if e == 0.5:
            return f"sqrt_rn({a})"
        return f"{libm}({a}, {ref(args[1])})"
    if name in ("maximum", "minimum"):
        b = ref(args[1])
        f = "fmax" if name == "maximum" else "fmin"
        return f"nan_or({a}, {b}, {f}({a}, {b}))"
    return f"{libm}({a})"


def emit_reaction(program: Program) -> str:
    """``program`` as the C++ ``__device__`` function ``gs_reaction``
    at its dtype: one ``const`` per op, in trace order."""
    ctype = DTYPES[program.dtype]

    def ref(r):
        kind = r[0]
        if kind == "field":
            return f"f[{r[1]}]"
        if kind == "lap":
            return f"lap[{r[1]}]"
        if kind == "noise":
            return "noise"
        if kind == "param":
            return f"p[{r[1]}]"
        if kind in ("scalar", "const"):
            return literal(r[1], program.dtype)
        return f"t{r[1]}"

    lines = [
        "__device__ __forceinline__ void gs_reaction(",
        f"    const {ctype}* f, const {ctype}* lap, {ctype} noise,",
        f"    const {ctype}* p, {ctype}* d) {{",
    ]
    for k, (name, args) in enumerate(program.ops):
        expr = _expression(name, args, ref, program.dtype)
        lines.append(f"  const {ctype} t{k} = {expr};")
    for i, r in enumerate(program.outputs):
        lines.append(f"  d[{i}] = {ref(r)};")
    lines.append("}")
    return "\n".join(lines)


def emit_source(model, programs: Dict[str, Program]) -> str:
    """The generated part of the kernel for ``model``: the field and
    parameter counts, where ``dt`` and ``noise`` sit in the params
    vector, and ``gs_reaction`` for float and double."""
    fields = tuple(model.params_cls._fields)
    head = [
        f"// Generated by grayscott_jl_tpu_torch/ops/kernelgen.py "
        f"(GENERATOR_VERSION {GENERATOR_VERSION})",
        f"// for model {model.name!r}: fields {tuple(model.field_names)}, "
        f"params {fields}.",
        f"constexpr int kNF = {len(model.field_names)};",
        f"constexpr int kNP = {len(fields)};",
        f"constexpr int kDt = {fields.index('dt')};",
        f"constexpr int kNoise = {fields.index('noise')};",
    ]
    body = [emit_reaction(programs[d]) for d in DTYPES]
    return "\n".join(head) + "\n\n" + "\n\n".join(body) + "\n"


def build_spec(model) -> KernelSpec:
    """Spec for ``model``, or :class:`KernelGenError` naming the reason
    when generation is infeasible (callers wanting a non-raising check
    use :func:`generation_gate_reason`)."""
    programs = {}
    for dtype in DTYPES:
        program, reason = _trace(model, dtype)
        if reason is not None:
            raise KernelGenError(
                f"cannot generate a CUDA kernel for model "
                f"{model.name!r}: {reason}"
            )
        programs[dtype] = program
    return KernelSpec(
        name=model.name,
        n_fields=len(model.field_names),
        field_names=tuple(model.field_names),
        boundaries=tuple(float(b) for b in model.boundaries),
        param_fields=tuple(model.params_cls._fields),
        params_cls=model.params_cls,
        reaction=model.reaction,
        model=model,
        programs=programs,
        cuda_source=emit_source(model, programs),
    )


#: Memoized specs keyed on the model object.
_SPECS: dict = {}


def get_spec(model) -> KernelSpec:
    """The (memoized) spec of ``model``; raises :class:`KernelGenError`
    for a model the generator refuses."""
    key = (model.name, id(model))
    spec = _SPECS.get(key)
    if spec is None:
        spec = _SPECS[key] = build_spec(model)
    return spec
