"""Scene description, host build and device tables."""
from .build import build_scene  # noqa: F401
from .schema import load_scene_desc  # noqa: F401
