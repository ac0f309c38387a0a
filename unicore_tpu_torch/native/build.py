"""Build the native host library: python -m unicore_tpu_torch.native.build

Compiles native/fastio.cpp with g++ into build/unicore_tpu_torch/ (the
library the featurizer would otherwise build at its first call) and
prints its path.
"""

from __future__ import annotations

import sys

from unicore_tpu_torch import native


def main() -> int:
    print(native.build_library())
    return 0


if __name__ == "__main__":
    sys.exit(main())
