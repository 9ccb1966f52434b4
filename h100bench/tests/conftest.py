"""The port's sources on the path, as ``h100bench.run`` puts them."""

import sys

from h100bench.bench import CHECKOUT

if str(CHECKOUT / "src") not in sys.path:
    sys.path.insert(0, str(CHECKOUT / "src"))
