"""Post-handler framework (reference: pkg/fanal/handler/handler.go).

PostHandlers run per blob after analysis, in descending priority
order; their versions feed cache keys alongside analyzer versions so
a handler change invalidates cached blobs.
"""

from .handler import (PostHandler, handler_versions, post_handle,
                      register_post_handler)
from . import gomod as _gomod  # noqa: F401  (registers on import)
from . import misconf as _misconf  # noqa: F401
from . import sysfile as _sysfile  # noqa: F401
from . import unpackaged as _unpackaged  # noqa: F401

__all__ = ["PostHandler", "register_post_handler", "post_handle",
           "handler_versions"]
