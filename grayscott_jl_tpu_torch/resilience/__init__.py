"""Run resilience (counterpart of ``grayscott_jl_tpu/resilience/``): the
field health guard (:mod:`.health`), graceful shutdown (:mod:`.faults`)
and data integrity (:mod:`.integrity`: checksums, checkpoint replicas
and failover, the scrubber). The supervisor, fault plans, watchdog and
SDC screening are not ported yet (ROADMAP Queue 1 item 17)."""
