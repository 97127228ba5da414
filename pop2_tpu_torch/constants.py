"""Physical and numerical constants (CGS units, matching the reference model).

Reference: ``source/pop_constants.F90:234-365`` (non-CCSM branch). POP2 works in
CGS internally: lengths in cm, velocities in cm/s, density in g/cm^3, tracers
TEMP in degC and SALT in g/g (msu).
"""

import math

# geometry / rotation (source/pop_constants.F90:234-241)
T0_KELVIN = 273.16
GRAV = 980.6                 # gravitational accel. (cm/s^2)
OMEGA = 7.292123625e-5       # angular velocity of Earth (rad/s)
RADIUS = 6370.0e5            # radius of Earth (cm)
RHO_SW = 4.1 / 3.996         # density of salt water (g/cm^3)
RHO_FW = 1.0                 # density of fresh water (g/cm^3)
CP_SW = 3.996e7              # specific heat of salt water (erg/g/K)

LATENT_HEAT_FUSION = 3.34e9  # latent heat of fusion (erg/g)
LATENT_HEAT_VAPOR_MKS = 2.5e6  # latent heat of vaporization (J/kg;
# pop_constants.F90:247)
SEA_ICE_SALINITY = 4.0       # salinity of sea ice formed (psu)
OCN_REF_SALINITY = 34.7      # ocean reference salinity (psu)

CMPERM = 100.0               # cm per meter
MPERCM = 0.01                # m per cm

SALT_TO_PPT = 1000.0         # salt (g/g) -> ppt
PPT_TO_SALT = 1.0e-3         # ppt -> g/g

PI = math.pi
PI2 = 2.0 * math.pi
RADIAN = 180.0 / math.pi     # degrees per radian

# unit-conversion factors for surface forcing
# (source/pop_constants.F90:309-365)
MOMENTUM_FACTOR = 10.0                       # N/m^2 -> (cm/s)^2 * g/cm^3
HFLUX_FACTOR = 1000.0 / (RHO_SW * CP_SW)     # W/m^2 -> degC*cm/s
FWFLUX_FACTOR = 1.0e-4                       # kg/m^2/s -> cm/s (fresh water)
# fwflux_factor = 1e-4 converts kg(freshwater)/m^2/s to msu*cm/s per psu
# (source/pop_constants.F90:336-365)
FWFLUX_FACTOR_SALT = 1.0e-4
SALINITY_FACTOR = -OCN_REF_SALINITY * FWFLUX_FACTOR_SALT  # (msu*cm/s)/(kg/m^2/s)
SFLUX_FACTOR = 0.1            # kg(salt)/m^2/s -> msu*cm/s
FWMASS_TO_FWFLUX = 0.1                       # kg/m^2/s -> cm/s

# sea water freezing point (linear, psu-based; source/pop_constants.F90)
CP_OVER_LHFUSION = RHO_SW * CP_SW / (LATENT_HEAT_FUSION * RHO_FW)

# transport diagnostic conversions (source/pop_constants.F90:263-265)
MASS_TO_SV = 1.0e-12         # cm^3/s -> Sverdrups
HEAT_TO_PW = 4.186e-15       # degC*cm^3/s -> Petawatts
SALT_TO_SVPPT = 1.0e-9       # msu*cm^3/s -> Sv*ppt
