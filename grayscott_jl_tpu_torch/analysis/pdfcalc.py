"""Streaming PDF analysis of simulation output, with the histograms on
the card (counterpart of ``grayscott_jl_tpu/analysis/pdfcalc.py``).

The reference's in-situ workflow, unchanged in what it reads and
writes:

* open the simulation output as a *streaming* reader —
  ``begin_step(timeout=10)``, sleep-and-retry on NOT_READY, stop
  otherwise — so it can run beside a live simulation or over a
  finished store;
* per step, for each x-slice of U and V, an ``nbins``-bin histogram of
  the slice's values between the block's min and max;
* slices split across workers along the slowest dimension with the
  remainder to the last worker;
* ``U/pdf``, ``U/bins``, ``V/pdf``, ``V/bins`` (and optionally the
  original U/V) written to one output store per step, shared by every
  worker.

The histograms run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, ``--backend CPU``); a missing card raises at start-up
and nothing falls back to the host. Each worker moves its selection to
its card once, counts there — a floor, a clamp and a ``bincount`` of
int64 counts, deterministic — and brings back only the
``(count_x, nbins)`` counts. The plain version is the same function on
the CPU; both equal the reference's numpy histogram bit for bit.

CLI (``python -m grayscott_jl_tpu_torch.analysis.pdfcalc``): the
reference's arguments — input, output, nbins (default 1000),
output_inputdata (default False) — and ``--backend CUDA|CPU``.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..io import open_reader, open_writer
from ..io.bplite import StepStatus

_EPS = 1.0e-20  # the reference's ``_epsilon`` threshold

#: ``--backend`` values.
BACKENDS = ("CUDA", "CPU")

#: The dtypes a block may hold, with the numpy dtype of its output.
_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def pdf_device(device=None, *, rank: int = 0, size: int = 1) -> torch.device:
    """The device the histograms run on: ``device`` when given, else the
    CUDA card of worker ``rank`` of ``size``, placed as ``launch.py``
    places a process (``parallel/distributed.placement``). A card asked
    for and not there is an error, never a quiet move to the host."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"pdfcalc: device {str(dev)!r} is a CUDA card, but "
                "torch.cuda.is_available() is False on this machine")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "pdfcalc computes its histograms on the CUDA card, but "
            "torch.cuda.is_available() is False on this machine; pass "
            "--backend CPU (device=\"cpu\") to compute them on the host")
    from ..parallel.distributed import placement

    _, cards = placement("cuda", torch.cuda.device_count(), rank, size)
    return torch.device("cuda", cards[0])


def compute_pdf(
    data, nbins: int, *, device=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-slice histograms of a (nslices, ny, nz) block (a numpy array
    or a tensor), computed on ``device`` (:func:`pdf_device`: the card
    unless the caller asks for the CPU).

    Returns numpy ``(pdf, bins)`` with shapes ``(nslices, nbins)`` and
    ``(nbins,)`` in the block's dtype, equal to the reference's bit for
    bit: counts of values in ``nbins`` equal bins spanning [min, max] of
    the whole block, lower-edge bin convention with the top value
    folded into the last bin. Degenerate windows (single bin, or
    max-min below epsilon) fill ``slice_size`` per bin. The bin index
    is the reference's float arithmetic in the block's dtype: a true
    division by a bin width that lives on the same device (CUDA divides
    by a host scalar as a product with its reciprocal, which moves
    cells across bin edges); a NaN or infinite quotient lands in bin 0,
    where numpy's int64 cast and clip send it.
    """
    dev = pdf_device(device)
    x = torch.as_tensor(data)
    if x.dtype not in _DTYPES:
        raise TypeError(
            f"pdfcalc takes float32 or float64 blocks; got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(
            "zero-size array to reduction operation minimum which has no "
            "identity")
    out_dtype = _DTYPES[x.dtype]
    nslices = x.shape[0]
    slice_size = int(np.prod(x.shape[1:], dtype=np.int64))
    x = x.to(dev)
    lo, hi = torch.stack((x.min(), x.max())).tolist()
    bin_width = (hi - lo) / nbins
    bins = (lo + np.arange(nbins) * bin_width).astype(out_dtype)

    if nbins == 1 or (hi - lo) < _EPS or bin_width < _EPS:
        pdf = np.full((nslices, nbins), slice_size, dtype=out_dtype)
        return pdf, bins

    lo_t = torch.tensor(lo, dtype=x.dtype, device=dev)
    width_t = torch.tensor(bin_width, dtype=x.dtype, device=dev)
    q = torch.floor((x.reshape(nslices, -1) - lo_t) / width_t)
    q = torch.nan_to_num(q, nan=0.0, posinf=0.0, neginf=0.0)
    idx = q.to(torch.int64).clamp_(0, nbins - 1)
    idx += torch.arange(nslices, device=dev).unsqueeze(1) * nbins
    counts = torch.bincount(idx.reshape(-1), minlength=nslices * nbins)
    pdf = counts.reshape(nslices, nbins).cpu().numpy()
    return pdf.astype(out_dtype), bins


def split_slowest_dim(n: int, size: int, rank: int) -> Tuple[int, int]:
    """(start, count) of worker ``rank``'s share of ``n`` slices: floor
    division with the remainder going to the last worker."""
    count = n // size
    start = count * rank
    if rank == size - 1:
        count = n - count * (size - 1)
    return start, count


def parse_arguments(args: List[str]) -> argparse.Namespace:
    """The reference's CLI contract, and ``--backend``."""
    p = argparse.ArgumentParser(
        prog="pdfcalc",
        description="gray-scott workflow pdf generator, PyTorch/CUDA "
                    "version",
    )
    p.add_argument("input", help="Name of the input file handle for reading data")
    p.add_argument(
        "output", help="Name of the output file to which data must be written"
    )
    p.add_argument(
        "N",
        nargs="?",
        type=int,
        default=1000,
        help="Number of bins for the PDF calculation, default = 1000",
    )
    p.add_argument(
        "output_inputdata",
        nargs="?",
        type=lambda s: s.lower() in ("yes", "true", "1"),
        default=False,
        help="YES will write the original variables besides the analysis results",
    )
    p.add_argument(
        "--backend", default="CUDA", choices=BACKENDS,
        help="CUDA (the default) computes the histograms on the card; CPU "
             "on the host",
    )
    return p.parse_args(args)


def read_data_write_pdf(
    in_filename: str,
    out_filename: str,
    nbins: int = 1000,
    write_inputvars: bool = False,
    *,
    rank: int = 0,
    size: int = 1,
    timeout: float = 10.0,
    max_not_ready: Optional[int] = None,
    verbose: bool = False,
    device=None,
) -> int:
    """Streaming read -> per-slice PDF -> write loop. Returns steps
    processed.

    ``rank``/``size`` split the slowest (x) dimension across workers;
    with one worker the whole volume is processed. ``max_not_ready``
    bounds the NOT_READY retries (None = retry forever, the reference
    behavior). ``device`` is where the histograms run
    (:func:`pdf_device`: worker ``rank``'s card unless the caller asks
    for the CPU), resolved before anything is opened.
    """
    dev = pdf_device(device, rank=rank, size=size)
    # live=True: the simulation may not have written its first step yet,
    # so the store is allowed not to exist (begin_step polls NOT_READY
    # until it appears).
    reader = open_reader(in_filename, live=True)
    # All workers cooperate on ONE output store.
    writer = open_writer(out_filename, writer_id=rank, nwriters=size)

    defined = False
    not_ready = 0
    steps_done = 0
    while True:
        status = reader.begin_step(timeout=timeout)
        if status == StepStatus.NOT_READY:
            not_ready += 1
            if max_not_ready is not None and not_ready > max_not_ready:
                break
            time.sleep(1.0)
            continue
        if status != StepStatus.OK:
            break
        not_ready = 0

        var_u = reader.inquire_variable("U")
        shape = var_u.shape
        start_x, count_x = split_slowest_dim(shape[0], size, rank)
        sel_start = (start_x, 0, 0)
        sel_count = (count_x, shape[1], shape[2])
        reader.set_selection("U", sel_start, sel_count)
        reader.set_selection("V", sel_start, sel_count)

        u = reader.get("U")
        v = reader.get("V")
        sim_step = int(reader.get("step"))
        reader.end_step()

        if not defined:
            dt = var_u.dtype.name
            writer.define_attribute("nbins", nbins)
            writer.define_attribute("input", in_filename)
            writer.define_variable("step", np.int32)
            writer.define_variable("U/pdf", dt, (shape[0], nbins))
            writer.define_variable("U/bins", dt, (nbins,))
            writer.define_variable("V/pdf", dt, (shape[0], nbins))
            writer.define_variable("V/bins", dt, (nbins,))
            if write_inputvars:
                writer.define_variable("U", dt, shape)
                writer.define_variable("V", dt, shape)
            defined = True

        u_pdf, u_bins = compute_pdf(u, nbins, device=dev)
        v_pdf, v_bins = compute_pdf(v, nbins, device=dev)

        writer.begin_step()
        writer.put("step", np.int32(sim_step))
        writer.put("U/pdf", u_pdf, start=(start_x, 0), count=(count_x, nbins))
        writer.put("U/bins", u_bins)
        writer.put("V/pdf", v_pdf, start=(start_x, 0), count=(count_x, nbins))
        writer.put("V/bins", v_bins)
        if write_inputvars:
            writer.put("U", u, start=sel_start, count=sel_count)
            writer.put("V", v, start=sel_start, count=sel_count)
        writer.end_step()
        steps_done += 1
        if verbose:
            print(f"pdfcalc: processed sim step {sim_step}", flush=True)

    writer.close()
    reader.close()
    return steps_done


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry. Workers share the simulation's multi-process
    environment contract: start ``GS_TPU_NUM_PROCESSES`` copies, each
    with its own ``GS_TPU_PROCESS_ID``; each reads its x-share via
    selection, counts on its own card (``--backend CUDA``), and writes
    its block into ONE shared multi-writer output store."""
    import sys

    from ..config.env import env_int

    ns = parse_arguments(sys.argv[1:] if argv is None else argv)
    rank = env_int("GS_TPU_PROCESS_ID", 0)
    size = env_int("GS_TPU_NUM_PROCESSES", 1)
    if not 0 <= rank < size:
        raise SystemExit(
            f"pdfcalc: GS_TPU_PROCESS_ID={rank} out of range for "
            f"GS_TPU_NUM_PROCESSES={size}"
        )
    read_data_write_pdf(
        ns.input, ns.output, ns.N, ns.output_inputdata,
        rank=rank, size=size, verbose=rank == 0,
        device="cpu" if ns.backend == "CPU" else None,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
