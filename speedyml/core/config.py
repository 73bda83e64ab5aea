"""Single typed configuration for the whole framework.

Replaces the reference's three uncoordinated config mechanisms (hard-coded
parameter blocks recompiled per experiment, sed-patched config.sh, fort.2
runtime file — SURVEY.md section 5.6; reference: src/mod_tsteps.f90,
src/mod_atparam.f90, src/mod_reservoir.f90:12-77).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Atmosphere resolution + time stepping (mod_atparam.f90, mod_tsteps.f90)."""

    # spectral resolution (T30 L8 default)
    ntrun: int = 30
    ix: int = 96
    il: int = 48
    kx: int = 8
    ntr: int = 1          # number of tracers (tr 0 = specific humidity, g/kg)

    # time stepping (mod_tsteps.f90:19,84-99)
    nsteps: int = 96      # steps per day
    rob: float = 0.05     # Robert filter
    wil: float = 0.53     # Williams filter
    alph: float = 0.5     # semi-implicit centering

    # physics cadence
    nstrad: int = 3       # shortwave radiation period (steps)
    sppt_on: bool = False
    rdf_on: bool = False  # random diabatic forcing (ini_inirdf, mod_randfor)
    rdf_index: int = 1    # perturbation index; sign flips the pattern

    # post-processing (time-mean diagnostics, mod_tmean/ppo_tminc)
    time_means_on: bool = False
    nstppr: int = 6       # post-proc sampling period in steps (mod_tsteps.f90:25)

    # seasonal cycle flag (1 = yes)
    iseasc: int = 1

    # start date
    iyear0: int = 1981
    imont0: int = 1

    # numerics
    dtype: str = "float32"   # "float32" on the GPU, "float64" for validation
    # grid-space tendency compute dtype: "bfloat16" halves the HBM traffic of
    # the dominant elementwise tendency work (spectral state/transforms stay
    # in `dtype`); opt-in fast path for large-ensemble throughput runs
    grid_compute: str = "float32"

    @property
    def mx(self) -> int:
        return self.ntrun + 1

    @property
    def nx(self) -> int:
        return self.ntrun + 2

    @property
    def iy(self) -> int:
        return self.il // 2

    @property
    def delt(self) -> float:
        return 86400.0 / self.nsteps

    @property
    def delt2(self) -> float:
        return 2.0 * self.delt


@dataclasses.dataclass(frozen=True)
class ReservoirConfig:
    """Reservoir-computing hyperparameters (mod_reservoir.f90:12-77,
    mod_slab_ocean_reservoir.f90:9-133)."""

    # domain decomposition
    number_of_regions: int = 1152
    num_vert_levels: int = 1
    vert_loc_overlap: int = 8
    overlap: int = 1             # horizontal halo in gridpoints

    # atmosphere reservoir
    nodes_per_input: int = 6000  # target m; actual n rounded to multiple of inputs
    degree: int = 6
    sigma: float = 0.5           # input weight scale
    leakage: float = 1.0
    beta_res: float = 0.001
    beta_model: float = 1.0
    prior_val: float = 0.0
    noise_std: float = 0.20

    # spectral radius by latitude band (res_domain.f90:1623-1660)
    radius_low: float = 0.3
    radius_high: float = 0.9

    # cadence (hours)
    timestep: int = 6
    timestep_slab: int = 168
    synclength: int = 336
    discardlength: int = 240
    traininglength: int = 166440
    predictionlength: int = 8760

    # data transforms
    precip_epsilon: float = 0.001
    # ceiling [mm per window] for the PREDICTED log-precip channel: the
    # linear readout must not extrapolate the exp-stretched log1p(P/eps)
    # channel beyond the training support (train_hybrid overwrites this
    # with the actual max of the training series)
    precip_cap_mm: float = 40.0
    ml_only: bool = False
    use_precip: bool = True
    use_tisr: bool = True
    use_sst: bool = True

    # slab ocean reservoir
    slab_nodes: int = 4000
    slab_sigma: float = 0.6
    slab_beta_res: float = 1e-4
    slab_noise_std: float = 0.10
    slab_leakage: float = 1.0
    # max |predicted SST - climatology| fed back to the coupled system [K]
    # (0 disables); the anomaly analog of the reference's 6 K hybrid-SST
    # acceptance gate (cpl_sea.f90:38-44) — see OceanModel.compose_sst
    slab_anom_clip: float = 6.0
    sst_variance_threshold: float = 0.2


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Top-level experiment config."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    reservoir: ReservoirConfig = dataclasses.field(default_factory=ReservoirConfig)
