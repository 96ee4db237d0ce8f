from .finite_port import (  # noqa: F401
    expected_exit_fraction,
    ideal_cosine_flux,
    port_area_fraction,
    projection_factor_curve,
    projection_factor_grid,
    projection_factor_quad,
    sphere_multiplier,
    subtended_flux,
)
from .flux_analysis import (  # noqa: F401
    FileData,
    ProfileFit,
    analyze,
    analyze_single,
    average_runs,
    collect_files,
    cosine_func,
    fit_cosine,
    load,
    plot_heatmaps,
    plot_theta_comparison,
    theta_profile,
)
from .ray_analysis import load_ray_log, plot_z_distribution, z_angle_distribution  # noqa: F401
