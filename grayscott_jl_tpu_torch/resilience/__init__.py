"""Run resilience (counterpart of ``grayscott_jl_tpu/resilience/``): the
field health guard (:mod:`.health`) and graceful shutdown
(:mod:`.faults`). The supervisor, fault plans, watchdog and SDC
screening are not ported yet (ROADMAP Queue 1 item 17)."""
