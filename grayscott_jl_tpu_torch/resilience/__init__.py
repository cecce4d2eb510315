"""Run resilience (counterpart of ``grayscott_jl_tpu/resilience/``): the
supervisor's restart loop (:mod:`.supervisor`), fault plans and graceful
shutdown (:mod:`.faults`), the hang watchdog (:mod:`.watchdog`), the
field health guard and drift gate (:mod:`.health`), data integrity
(:mod:`.integrity`: checksums, checkpoint replicas and failover, the
scrubber), compute-path SDC screening and device quarantine
(:mod:`.sdc`) and the restart rendezvous of a run of several processes
(:mod:`.rendezvous`)."""
