"""The analysis workflow (counterpart of ``grayscott_jl_tpu/analysis``):
``pdfcalc`` streams a store and computes per-slice PDFs on the card,
``gdsplot`` draws slices and PDF heatmaps, ``decomp`` prints the domain
decomposition. Nothing is imported here, so that ``decomp`` and
``gdsplot`` run without torch."""
