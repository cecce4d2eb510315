"""``python -m grayscott_jl_tpu_torch <config.toml>``."""

from . import cli_main

if __name__ == "__main__":
    cli_main()
