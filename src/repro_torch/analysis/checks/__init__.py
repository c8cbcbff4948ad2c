"""Built-in saralint checks.  Importing this package registers all four."""

from . import cow_gate  # noqa: F401
from . import dispatch_escape  # noqa: F401
from . import kernel_contract  # noqa: F401
from . import obs_taxonomy  # noqa: F401
