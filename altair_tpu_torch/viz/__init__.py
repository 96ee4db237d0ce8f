from .distribution import plot_distribution_canvas  # noqa: F401
from .ascii import ascii_fluxmap, ascii_ray_projection  # noqa: F401
from .html import export_html  # noqa: F401
from .rays import RayPaths, plot_rays, print_census, trace_paths  # noqa: F401
