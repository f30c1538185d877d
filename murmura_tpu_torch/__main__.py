"""``python -m murmura_tpu_torch`` entry point."""

from murmura_tpu_torch.cli import main

main()
