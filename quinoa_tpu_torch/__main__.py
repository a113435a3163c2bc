"""python -m quinoa_tpu_torch {inciter -c deck.q -i mesh, walker -c deck.q}
[options]"""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
