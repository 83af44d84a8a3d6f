# The ghost cache and the tuner's Newton step; the rest of the memory
# tuner (derivatives, controller) is not ported yet.
from .simcache import GhostCache  # noqa: F401
from .tuner import TunerConfig, newton_step  # noqa: F401
