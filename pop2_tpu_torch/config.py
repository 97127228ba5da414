"""Model configuration.

A single frozen (hashable) dataclass tree replaces the reference's ~60 Fortran
namelists in ``pop2_in`` plus the compile-time ``domain_size.F90`` generated
files (reference: ``source/POP_ConfigMod.F90``, ``input_templates/*_domain_size.F90``,
``bld/build-namelist``). Because the config is hashable it can be passed as a
dictionary key and compared by value — grid shapes and physics-scheme choices
are fixed for the life of a ``Model``, the role the generated Fortran files
played. The PyTorch port keeps the whole menu of the JAX package's config so
the two packages accept the same presets; switches whose physics the port does
not carry yet are refused when a ``Model`` is built (model.py).

Presets mirror the reference's supported grids
(``input_templates/test_domain_size.F90:26-46`` and per-grid headers).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class RegionBox:
    """Inclusive index box (0-based) in (k, j, i) for overflow regions."""
    kmin: int
    kmax: int
    jmin: int
    jmax: int
    imin: int
    imax: int


@dataclass(frozen=True)
class OverflowSpec:
    """One overflow's parameters (source/overflows.F90 ovf_params plus
    the region definitions the reference reads from overflows_infile).

    The point data (kmt changes, sidewall grid boxes with orientations)
    mirrors the overflows_infile format documented in its header
    (input_templates/gx1v7_overflow:1-40); all indices here are 0-based.
    Orientation: 1 = +x (east sidewall), 2 = +y, 3 = -x, 4 = -y."""
    name: str
    lat: float                 # degrees, for f
    width: float               # Ws (cm)
    source_thick: float        # hu (cm)
    distnc_str_ssb: float      # xse (cm)
    bottom_slope: float        # alpha
    bottom_drag: float         # cd
    inf: RegionBox
    src: RegionBox
    ent: RegionBox
    prd: RegionBox
    # (i, j, kmt_old, kmt_new) topography pop-ups (1-based kmt counts)
    kmt_changes: Tuple[Tuple[int, int, int, int], ...] = ()
    # (i, j, k, orient) sidewall grid boxes (k 0-based level index)
    src_pts: Tuple[Tuple[int, int, int, int], ...] = ()
    ent_pts: Tuple[Tuple[int, int, int, int], ...] = ()
    # product sets ordered by increasing depth; each a tuple of points
    prd_sets: Tuple[Tuple[Tuple[int, int, int, int], ...], ...] = ()


@dataclass(frozen=True)
class SolverConfig:
    """Barotropic elliptic solver options (source/POP_SolversMod.F90:502-700)."""

    choice: str = "ChronGear"          # 'ChronGear' | 'PCSI' | 'pcg'
    convergence_criterion: float = 1.0e-13
    max_iterations: int = 1000
    convergence_check_freq: int = 10
    convergence_check_start: int = 60  # PCSI only
    preconditioner: str = "diagonal"   # 'diagonal' | 'file' (9-pt stencil;
    #                                    EVP subsumed by PCSI, solvers.py)
    #                                  | 'spai' (9-pt SPAI generated at
    #                                    init, solvers.build_spai9)
    preconditioner_file: Optional[str] = None  # .npz of Precond9 fields
    # inner solver of the mixed-precision refined solve: ChronGear (CG) by
    # default — CG needs no spectrum bounds, and fp32 Lanczos Ritz values
    # OVERestimate the smallest eigenvalue, which makes a Stiefel inner
    # iteration stagnate on the modes below its assumed bound ('choice'
    # keeps the configured solver as the inner)
    refine_inner: str = "chrongear"    # 'chrongear' | 'choice'
    lanczos_iterations: int = 100      # PCSI eigenvalue estimation
    # precision of the elliptic solve: 'model' follows ModelConfig.dtype;
    # 'float64' promotes the 2-D solve to fp64 regardless of the model
    # dtype so the production convergence_criterion=1e-13
    # (namelist_defaults_pop.xml:258) is reachable under an fp32 model —
    # the solve is 2-D and the GPU has a native fp64 datapath, so its cost
    # is small next to the 3-D physics
    solve_dtype: str = "model"         # 'model' | 'float64'


@dataclass(frozen=True)
class TimeConfig:
    """Timestep / time-mixing options (source/time_management.F90:421-592)."""

    dt_option: str = "steps_per_day"
    dt_count: float = 45.0             # steps per day by default
    # 'avg' | 'avgfit' | 'robert' (Matsuno not rebuilt). 'avgfit' fits the
    # timestep so every coupling interval (day/fit_freq) ends exactly on a
    # full step (source/time_management.F90:795-870)
    time_mix_opt: str = "avg"
    time_mix_freq: int = 17            # averaging interval (steps)
    fit_freq: int = 1                  # coupling intervals per day (avgfit)
    robert_alpha: float = 1.0          # Robert filter alpha
    robert_nu: float = 0.1             # Robert filter strength
    impcor: bool = True                # implicit treatment of Coriolis
    dtuxcel: float = 1.0               # momentum timestep accel factor
    # depth-dependent tracer acceleration (Bryan 1984; laccel + accel_file,
    # source/time_management.F90:975-1009, input_templates/gx1v7_depth_accel):
    # per-level factors multiplying dtt; the top layer is forced to 1.0
    laccel: bool = False
    dttxcel: Optional[Tuple[float, ...]] = None
    # calendar (time_manager date arithmetic,
    # source/time_management.F90:256-283, 1283-1767)
    start_year: int = 1
    start_month: int = 1
    start_day: int = 1
    allow_leapyear: bool = False
    # leapfrog time-centering params (source/time_management.F90:437-439)
    alpha: float = 1.0 / 3.0
    theta: float = 0.5

    def avgfit_params(self):
        """Step counts and fitted dtt for time_mix_opt='avgfit'
        (source/time_management.F90:799-870): an averaging step advances
        time by dtt/2, so dtt is chosen such that each coupling interval
        (seconds_in_day/fit_freq) holds exactly ``fullsteps_per_interval``
        full + ``halfsteps_per_interval`` half steps and ends on a full
        step. Returns (full, half, nsteps_per_interval, dtt)."""
        if self.time_mix_freq <= 3:
            raise ValueError("avgfit requires time_mix_freq > 3 "
                             "(source/time_management.F90:811)")
        if self.dt_option != "steps_per_day":
            raise ValueError("avgfit fits steps to the day; use "
                             "dt_option='steps_per_day'")
        tmf = self.time_mix_freq
        full = max(int(self.dt_count) // self.fit_freq, 1)
        half = (tmf + full) // (tmf - 1)
        n = full + half
        # never end an interval on a half step (:831-849)
        if n % tmf == 0 or (full == 1 and half == 1):
            full += 1
            half = (tmf + full) // (tmf - 1)
            n = full + half
        dtt = 86400.0 / (self.fit_freq * (full + 0.5 * half))
        return full, half, n, dtt

    @property
    def dtt(self) -> float:
        """Tracer timestep in seconds (source/time_management.F90:754-791);
        avgfit returns the fitted value (:861-864)."""
        seconds_in_day = 86400.0
        if self.time_mix_opt == "avgfit":
            return self.avgfit_params()[3]
        if self.dt_option == "steps_per_day":
            return seconds_in_day / self.dt_count
        if self.dt_option == "seconds":
            return float(self.dt_count)
        if self.dt_option == "hours":
            return float(self.dt_count) * 3600.0
        if self.dt_option == "steps_per_year":
            return seconds_in_day * 365.0 / self.dt_count
        raise ValueError(f"unknown dt_option {self.dt_option}")

    @property
    def dtu(self) -> float:
        return self.dtt * self.dtuxcel

    @property
    def dtp(self) -> float:
        return self.dtt * self.dtuxcel

    @property
    def gamma(self) -> float:
        return 1.0 - 2.0 * self.alpha


@dataclass(frozen=True)
class ModelConfig:
    """Full model configuration; frozen and hashable."""

    # -- grid dimensions (compile-time in the reference:
    #    input_templates/test_domain_size.F90:26-46)
    nx: int = 192
    ny: int = 128
    km: int = 20
    nt: int = 2                        # number of tracers (>=2: TEMP, SALT)
    passive_tracers: Tuple[str, ...] = ()  # package names; nt = 2 + total

    # -- boundary conditions (source/domain.F90 domain_nml)
    ew_boundary: str = "cyclic"        # 'cyclic' | 'closed'
    ns_boundary: str = "closed"        # 'closed' | 'cyclic' | 'tripole'

    # -- grid generation (source/grid.F90 grid_nml)
    horiz_grid: str = "internal"       # 'internal' | 'file'
    vert_grid: str = "internal"
    topography: str = "internal"
    horiz_grid_file: Optional[str] = None
    vert_grid_file: Optional[str] = None
    topography_file: Optional[str] = None
    flat_bottom: bool = True           # internal topography is flat-bottomed
    partial_bottom_cells: bool = False
    bottom_cell_file: Optional[str] = None  # DZBC record (grid.F90:2116)
    sfc_layer: str = "varthick"        # 'varthick' | 'rigid' | 'oldfree'
    n_topo_smooth: int = 0

    # -- physics scheme choices
    state_choice: str = "mwjf"         # 'mwjf' | 'linear' | 'jmcd'
    state_range_opt: str = "enforce"   # 'ignore' | 'enforce'
    tadvect: str = "centered"          # 'centered' | 'upwind3' | 'lw_lim'
    hmix_momentum: str = "del2"        # 'del2' | 'del4' | 'aniso'
    hmix_tracer: str = "del2"          # 'del2' | 'del4' | 'gm'
    vmix: str = "const"                # 'const' | 'rich' | 'kpp'
    implicit_vertical_mix: bool = True
    aidif: float = 1.0                 # implicit vmix time-centering
    bottom_drag: float = 1.0e-3        # quadratic bottom drag coefficient
    convection_type: str = "diffusion" # 'diffusion' | 'adjustment'
    nconvad: int = 2
    convect_diff: float = 1000.0       # convective diffusivity (cm^2/s)
    convect_visc: float = 1000.0
    lpressure_avg: bool = True
    lbouss_correct: bool = False
    reset_to_freezing: bool = True
    liceform: bool = False
    sw_absorption: str = "none"        # 'none' | 'jerlov' | 'chlorophyll'
    jerlov_water_type: int = 3
    chl_option: str = "const"          # 'const' | 'file' | 'model'
    chl_const: float = 0.1             # mg/m^3 when chl_option='const'
    # standalone surface freshwater forcing (forcing_sfwf.F90:252-270
    # namelist defaults; the coupled path is coupled.py)
    sfwf_formulation: str = "restoring"  # 'restoring' | 'bulk-NCEP'
    sfwf_restore_tau: float = 1.0e20     # days (:258)
    sfwf_weak_restore: float = 0.092     # kg/s/m^2/msu (:265)
    sfwf_strong_restore: float = 0.6648  # (:267)
    sfwf_strong_restore_ms: float = 0.6648  # marginal seas (:266)
    ladjust_precip: bool = False         # annual precip balancing (:263)
    precip_fact_const: float = 1.0       # used unless ladjust_precip
    lfw_as_salt_flx: bool = True         # fw flux as virtual salt flux
    # interior T/S restoring (forcing_pt_interior.F90 / forcing_s_interior)
    pt_interior_restore_tau_days: float = 365.0
    pt_interior_restore_max_level: int = 0
    pt_interior_surface_restore: bool = False
    s_interior_restore_tau_days: float = 365.0
    s_interior_restore_max_level: int = 0
    s_interior_surface_restore: bool = False
    # geothermal bottom heat flux (geoheatflux.F90:84-90)
    geoheatflux_const: float = 0.0     # W/m^2
    geoheatflux_depth: float = 1000.0e2  # cm; applied below this depth
    # velocity damping (damping.F90)
    ldamp_uv: bool = False
    # estuary box model exchange circulation (estuary_vsf_mod.F90:194-201
    # namelist defaults; 2-D parameter files replaced by uniform values)
    lestuary_exch: bool = False
    est_tide_amp: float = 1.0          # m
    est_mouth_width: float = 2000.0    # m
    est_mouth_depth: float = 10.0      # m
    est_length_a1: float = 0.876
    est_tidal_pump_a2: float = 0.0
    est_lower_depth_ratio: float = 0.5  # h0 = h_lower/H
    est_h_upper: float = 10.0e2        # cm, exchange upper-layer thickness
    est_h_lower: float = 10.0e2        # cm
    # tidal mixing (tidal_mixing.F90:679-709; methods :44-60)
    ltidal_mixing: bool = False
    tidal_mixing_method: str = "jayne"  # 'jayne' | 'schmittner' | 'polzin'
    ltidal_schmittner_socn: bool = False  # Southern-Ocean deep floor
    tidal_h2_const: float = 1.0e8       # cm^2 roughness^2 (polzin; the
    #                                     reference reads a file)
    tidal_urms_const: float = 2.0       # cm/s barotropic tidal rms speed
    tidal_mix_max: float = 100.0             # cm^2/s cap
    tidal_local_mixing_fraction: float = 0.33
    tidal_mixing_efficiency: float = 0.20
    # 18.6-yr lunar nodal cycle modulation of the tidal energy
    # (tidal_mixing.F90 ltidal_lunar_cycle; tidal_mixing.py LNC factors)
    ltidal_lunar_cycle: bool = False
    tidal_vertical_decay_scale: float = 500.0e2  # cm
    tidal_energy_file: Optional[str] = None  # POP binary E(x,y) record
    tidal_energy_const: float = 0.0          # W/m^2 fallback when no file
    # near-inertial wave mixing (niw_mixing.F90:112-130)
    lniw_mixing: bool = False
    niw_energy_type: str = "external"  # 'external' | 'blke'
    niw_boundary_layer_absorption: float = 0.7
    niw_local_mixing_fraction: float = 0.5
    niw_mixing_efficiency: float = 0.2
    niw_obs2model_ratio: float = 1.0
    niw_vert_decay_scale: float = 2000.0e2   # cm
    niw_mix_max: float = 100.0               # cm^2/s
    niw_energy_file: Optional[str] = None
    niw_energy_const: float = 0.0            # W/m^2 fallback
    # topographic stress / Neptune (topostress.F90)
    ltopostress: bool = False
    nsmooth_topo: int = 1
    # overflows (source/overflows.F90; empty tuple = off)
    overflows: Tuple[OverflowSpec, ...] = ()
    # reference contract: overflow kmt-change records must agree with the
    # topography (init_overflows_kmt aborts on mismatch,
    # source/overflows.F90:1196-1275). True reproduces the abort; False
    # deactivates inconsistent overflows with a warning (model.py)
    overflow_geometry_strict: bool = False
    # submesoscale mixed-layer eddies (mix_submeso.F90:183-188)
    lsubmeso: bool = False
    submeso_efficiency: float = 0.07
    submeso_timescale: float = 8.64e4        # seconds (1 day;
    # namelist_defaults_pop.xml time_scale_constant)
    submeso_const_hls: bool = False
    submeso_hor_length_scale: float = 5.0e5  # cm (5 km)
    submeso_max_grid_scale: float = 111.0e5  # cm (~1 degree)

    # -- mixing coefficients
    am: Optional[float] = None         # horizontal viscosity; None -> auto
    ah: Optional[float] = None         # horizontal diffusivity; None -> auto
    am4: float = -0.6e20               # biharmonic viscosity
    ah4: float = -0.2e20               # biharmonic diffusivity
    # anisotropic viscosity (source/hmix_aniso.F90:202-226 defaults)
    aniso_alignment: str = "east"      # 'flow' | 'east' | 'grid'
    lvariable_hmix_aniso: bool = True  # CCSM spatially-varying coeffs
    lsmag_aniso: bool = False          # Smagorinsky nonlinear viscosity
    visc_para: float = 0.0             # constant parallel viscosity
    visc_perp: float = 0.0             # constant perpendicular viscosity
    c_para: float = 8.0                # smag dimensionless coefficients
    c_perp: float = 8.0
    # (the reference's u_para/u_perp smag background velocity scales are
    # dead there too: initialized/broadcast but never used in the
    # viscosity — source/hmix_aniso.F90:820 mentions them only in a
    # comment, defaults zero :209-210 — so they are not carried here)
    vconst_1: float = 1.0e7            # ccsm variable-viscosity params
    vconst_2: float = 24.5
    vconst_3: float = 0.2
    vconst_4: float = 1.0e-8           # 1/cm
    vconst_5: int = 3                  # western-boundary buffer (cells)
    vconst_6: float = 1.0e7
    vconst_7: float = 45.0             # degrees latitude
    smag_lat: float = 20.0             # smag latitude dependence
    smag_lat_fact: float = 0.98
    smag_lat_gauss: float = 98.0
    const_vvc: float = 0.25            # constant vertical viscosity (cm^2/s)
    const_vdc: float = 0.25            # constant vertical diffusivity (cm^2/s)
    # Richardson vmix (source/vmix_rich.F90)
    bckgrnd_vvc: float = 1.0
    bckgrnd_vdc: float = 0.1
    rich_mix: float = 50.0
    # GM / isopycnal mixing (source/hmix_gm.F90:405-420)
    gm_ah: float = 0.8e7             # isopycnal (Redi) diffusivity
    gm_ah_bolus: float = 0.8e7       # thickness (GM) diffusivity
    gm_ah_bkg_srfbl: float = 0.8e7   # horizontal diffusion in surface BL
    gm_ah_bkg_bottom: float = 0.0    # horizontal diffusion in bottom cell
    gm_slm_r: float = 0.3            # max slope for Redi tapering
    gm_slm_b: float = 0.3            # max slope for bolus tapering
    # flow-dependent kappa (source/hmix_gm.F90:1345-1399, 2226-2659,
    # 3011-3176); 'bfre' (normalized-N^2 vertical profile) is the
    # production default for every gx/tx grid
    # (bld/namelist_files/namelist_defaults_pop.xml:608-620)
    gm_kappa_isop_type: str = "const"  # 'const'|'depth'|'bfre'|'vmhs'|'eg'
    gm_kappa_thic_type: str = "const"
    gm_kappa_isop_deep: float = 0.1  # bfre deep floor (namelist kappa_isop_
    gm_kappa_thic_deep: float = 0.1  # _deep/kappa_thic_deep, defaults :427)
    # transition-layer parameterization (Danabasoglu et al. 2008;
    # source/hmix_gm.F90:3183-3840; default ON in production,
    # namelist_defaults_pop.xml:683)
    gm_transition_layer: bool = False
    gm_use_const_ah_bkg_srfbl: bool = True  # HOR_DIFF source (:1603-1628)
    gm_const_eg: float = 1.0         # Eden-Greatbatch tuning constant
    gm_gamma_eg: float = 300.0       # EG inverse-timescale cap
    gm_kappa_min_eg: float = 0.35e7  # cm^2/s
    gm_kappa_max_eg: float = 5.0e7   # cm^2/s
    gm_kappa_depth_1: float = 1.0    # depth-profile kappa parameters
    gm_kappa_depth_2: float = 0.0
    gm_kappa_depth_scale: float = 150000.0  # cm
    # anisotropic GM (source/hmix_gm_aniso.F90, Smith & Gent 2004): the
    # diffusivity becomes direction-dependent with the major axis along the
    # grid x-direction ('grid') or the local flow ('flow'); None = isotropic
    gm_aniso: Optional[str] = None
    gm_aniso_ratio: float = 0.2      # minor/major diffusivity ratio
    # KPP (source/vmix_kpp.F90:335-353)
    bckgrnd_vdc2: float = 0.0        # atan-profile amplitude
    bckgrnd_vdc_dpth: float = 2500.0e2   # transition depth (cm)
    bckgrnd_vdc_linv: float = 4.5e-5     # inverse transition length (1/cm)
    prandtl: float = 10.0
    num_v_smooth_ri: int = 1
    kpp_lrich: bool = True           # include shear-instability mixing
    kpp_ldbl_diff: bool = False      # double diffusion
    kpp_lshort_wave: bool = False    # radiative contribution to bldepth
    kpp_lcheckekmo: bool = False     # Ekman/Monin-Obukhov limits
    # horizontally-varying background diffusivity (Jochum 2009; the gx
    # production default, vmix_kpp.F90:544-632,
    # namelist_defaults_pop.xml:445-449); replaces the atan depth profile
    kpp_lhoriz_varying_bckgrnd: bool = False
    bckgrnd_vdc_eq: float = 0.01     # Gregg equatorial diffusivity
    bckgrnd_vdc_psim: float = 0.13   # MacKinnon max PSI diffusivity
    bckgrnd_vdc_ban: float = 1.0     # Gordon Banda Sea diffusivity

    # -- Coriolis options (source/grid.F90:1154-1172)
    lconst_coriolis: bool = False
    coriolis_val: float = 1.0e-4

    # -- sub-configs
    time: TimeConfig = field(default_factory=TimeConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)

    # -- numerics
    dtype: str = "float64"             # working precision
    # mesh: logical device mesh shape (y_axis, x_axis) for 2-D spatial sharding
    mesh_shape: Tuple[int, int] = (1, 1)
    # bit-for-bit reproducible global sums across decompositions: the
    # reference's b4b_flag (source/initial.F90:730-741,
    # mpi/global_reductions.F90:134,599) rebuilt as order-independent
    # fixed-point accumulation (reductions.py)
    b4b: bool = False
    # stream output format (tavg_nml tavg_fmt_out, io_pio pio_typename):
    # 'nc' = NetCDF3-classic (scipy), 'nc4' = netCDF-4/HDF5 (chunked +
    # compressed, io/netcdf4.py)
    tavg_fmt_out: str = "nc"

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "float64": torch.float64}[self.dtype]

    @property
    def auto_am(self) -> float:
        """Viscosity scaled to 1e7 at 1/2 degree (source/hmix_del2.F90:205)."""
        return self.am if self.am is not None else 1.0e7 * (720.0 / self.nx)

    @property
    def auto_ah(self) -> float:
        """Diffusivity scaled to 1e7 at 1/2 deg (source/hmix_del2.F90:534)."""
        return self.ah if self.ah is not None else 1.0e7 * (720.0 / self.nx)

    def with_(self, **kwargs) -> "ModelConfig":
        return replace(self, **kwargs)


def _preset(name: str, **kw) -> ModelConfig:
    return ModelConfig(**kw)


# Grid presets mirroring the reference's per-grid generated domain_size files.
# Dimensions from input_templates/*_domain_size.F90 headers (SURVEY.md §2.1).
PRESETS = {
    # test grid: 192x128x20, internal grids, cyclic E-W / closed N-S
    # (input_templates/test_domain_size.F90:26-46, input_templates/test_pop2_in)
    "test": ModelConfig(),
    # small test grid for CI: same physics, tiny dims
    "prod": ModelConfig(nx=384, ny=256, km=40),
    # production-physics benchmark: gx1v7-shaped (320x384x60,
    # input_templates/gx1v7_domain_size.F90) running the reference's real
    # gx1v7 default physics menu (bld/namelist_files/
    # namelist_defaults_pop.xml): tripole; KPP with the Jochum
    # horizontally-varying background + double diffusion + shortwave
    # bldepth term (:434-449); GM with bfre N^2 kappa + transition layer
    # (:608-620,683, ah=ah_bolus=ah_bkg_srfbl=3.0e7, isop_deep=0.2
    # :599-602); anisotropic 'east' viscosity (:543,739); Jayne tidal
    # mixing (:313,421); submesoscale MLE (:559); chlorophyll shortwave
    # absorption (:1039); frazil ice; Robert filter at 24 steps/day
    # (:36,48); PCSI at tol 1e-13 / maxiter 1000 (:256-259); overflows
    # ON (:1127) — the parsed real gx1v7 geometry is attached by
    # bench/get_production_config (config presets stay IO-free).
    # Topography/grid are internally generated (the real gx1v7
    # horiz-grid/topography files are not redistributable); depth
    # acceleration is OFF as in production (laccel :67; every shipped
    # *_depth_accel file is 1.0) and the chlorophyll field is the
    # constant stand-in for the non-redistributable monthly file.
    "prod_full": ModelConfig(
        nx=320, ny=384, km=60, nt=5, ns_boundary="tripole",
        flat_bottom=False, vmix="kpp", hmix_tracer="gm",
        tadvect="upwind3",   # the gx default (namelist_defaults:534)
        hmix_momentum="aniso", aniso_alignment="east",
        sw_absorption="chlorophyll", chl_option="const", chl_const=0.1,
        liceform=True, passive_tracers=("iage", "cfc"),
        kpp_ldbl_diff=True, kpp_lshort_wave=True,
        kpp_lhoriz_varying_bckgrnd=True, bckgrnd_vdc2=0.0,
        gm_kappa_isop_type="bfre", gm_kappa_thic_type="bfre",
        gm_kappa_isop_deep=0.2, gm_kappa_thic_deep=0.1,
        gm_transition_layer=True,
        gm_ah=3.0e7, gm_ah_bolus=3.0e7, gm_ah_bkg_srfbl=3.0e7,
        ltidal_mixing=True, tidal_mixing_method="jayne",
        tidal_energy_const=1.0e-3,
        lsubmeso=True,
        time=TimeConfig(dt_option="steps_per_day", dt_count=24.0,
                        time_mix_opt="robert"),
        solver=SolverConfig(choice="PCSI",
                            convergence_criterion=1.0e-13,
                            max_iterations=1000,
                            convergence_check_freq=10,
                            convergence_check_start=60,
                            preconditioner="fspai",
                            solve_dtype="float64"),
    ),
    "mini": ModelConfig(nx=32, ny=24, km=8, vert_grid="uniform",
                        time=TimeConfig(dt_option="steps_per_day",
                                        dt_count=96.0)),
    "gx3v5": ModelConfig(nx=100, ny=116, km=25, horiz_grid="file",
                         vert_grid="file", topography="file",
                         ns_boundary="closed", flat_bottom=False,
                         vmix="kpp", hmix_tracer="gm", hmix_momentum="aniso"),
    "gx3v7": ModelConfig(nx=100, ny=116, km=60, horiz_grid="file",
                         vert_grid="file", topography="file",
                         ns_boundary="closed", flat_bottom=False,
                         vmix="kpp", hmix_tracer="gm", hmix_momentum="aniso"),
    "gx1v7": ModelConfig(nx=320, ny=384, km=60, horiz_grid="file",
                         vert_grid="file", topography="file",
                         ns_boundary="tripole", flat_bottom=False,
                         vmix="kpp", hmix_tracer="gm", hmix_momentum="aniso"),
    "tx0.1v3": ModelConfig(nx=3600, ny=2400, km=62, horiz_grid="file",
                           vert_grid="file", topography="file",
                           ns_boundary="tripole", flat_bottom=False,
                           partial_bottom_cells=True,
                           vmix="kpp", hmix_tracer="del4",
                           hmix_momentum="del4"),
}


def get_config(name: str = "test", **overrides) -> ModelConfig:
    cfg = PRESETS[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
