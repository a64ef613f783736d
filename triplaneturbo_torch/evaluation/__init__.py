from .clipscore import CLIPScorer
from .mesh_render import RenderedViews, kire_camera_rig, render_mesh_views

__all__ = ["CLIPScorer", "RenderedViews", "render_mesh_views", "kire_camera_rig"]
