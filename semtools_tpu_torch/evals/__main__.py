"""``python -m semtools_tpu_torch.evals {realtext,retrieval,agent,fuzz_grep} [options]``."""

import importlib
import sys

DRIVERS = ("realtext", "retrieval", "agent", "fuzz_grep")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in DRIVERS:
        print(f"usage: python -m semtools_tpu_torch.evals {{{','.join(DRIVERS)}}} [options]",
              file=sys.stderr)
        return 2
    mod = importlib.import_module(f"semtools_tpu_torch.evals.{argv[0]}")
    return mod.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
