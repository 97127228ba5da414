"""CESM-shaped coupler cap: the init/run/final driver protocol around the
coupled-field adapter (coupled.py).

The port's copy of the JAX package's ``ocn_component.py``. Reference:
``drivers/mct/ocn_comp_mct.F90`` — ``ocn_init_mct`` (:123-504, registers
the coupler time flags, primes the export buffer), ``ocn_run_mct``
(:512-723, advances the model over one coupling interval: import at
interval start, step/output loop, KE blow-up guard, per-step export
accumulation, export + exit when the coupling flag fires, coupler-requested
restart via ``override_time_flag(cpl_write_restart)`` :610), and
``ocn_final_mct`` (:731). The export buffer is the time integral of the
surface fields over the interval (``pop_sum_buffer``,
drivers/nuopc/ocn_import_export.F90:1696-1815: delt-weighted sums of
surface U/V/T/S, GRADPX/Y, normalized by the accumulated time at export).

The ESMF/MCT plumbing itself (gsMaps, attribute vectors, clock sync) is
infrastructure of those frameworks, not model capability; this cap keeps
the protocol (advertised field lists, phase methods, coupling time flags,
restart-on-request) over plain dicts of tensors, so any driver can run the
ocean as a component. The coupler's forcing is new every interval, so
``run`` steps through ``Model.advance`` (eager), one step at a time.
Restarts are the port's ``io/restart`` checkpoints, whose format the JAX
package shares: a restart either package's component writes resumes in the
other's. ``OcnComponent(cfg)`` runs on the GPU; ``device="cpu"`` runs the
plain PyTorch path.

Under ``mesh_shape = (py, px)`` every rank of the process group runs a
component of its own block, as the CESM cap runs on every task: ``run``
imports the rank's block of ``x2o`` (block fields, or whole ones, which it
cuts) and exports the block of ``o2x`` (``gather_export`` assembles the
whole export); the time flags are the calendar's, the same on every rank;
its restarts are sharded (``io/sharded_restart``: every rank writes its
block, and a restart is read onto any mesh, or the whole domain).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from pop2_tpu_torch import constants as const
from pop2_tpu_torch.config import ModelConfig
from pop2_tpu_torch.coupled import IMPORT_FIELDS, ocn_import
from pop2_tpu_torch.ice import ice_flx_to_coupler
from pop2_tpu_torch.io import sharded_restart
from pop2_tpu_torch.io.restart import read_restart, write_restart
from pop2_tpu_torch.model import Model, one_process_mesh
from pop2_tpu_torch.parallel import mesh as pmesh
from pop2_tpu_torch.state import State
from pop2_tpu_torch.stencil import ugrid_to_tgrid


class OcnComponent:
    """Ocean component with the CESM cap protocol: initialize -> run (one
    coupling interval per call) -> finalize."""

    #: export fields advertised to the driver (ocn_export :535-760)
    EXPORT_FIELDS = ("So_t", "So_s", "So_u", "So_v", "So_dhdx", "So_dhdy",
                     "So_ssh", "So_bldepth", "Fioo_q")
    IMPORT_FIELDS = IMPORT_FIELDS

    def __init__(self, cfg: ModelConfig,
                 coupling_freq_opt: str = "nday", coupling_freq: int = 1,
                 restart_freq_opt: str = "never", restart_freq: int = 1,
                 outdir: str = ".", lfw_as_salt_flx: bool = True,
                 device="cuda"):
        if one_process_mesh(cfg):
            raise NotImplementedError(
                "the coupler cap on a one-process mesh is not ported: run "
                "it as ranks of a process group (a cap a rank, "
                "multihost.spawn_ranks) or on the whole domain")
        self.cfg = cfg
        self.model = Model(cfg, device=device)
        #: this rank's block (None: the whole domain)
        self.mesh = (self.model.mesh if pmesh.over_ranks(self.model.mesh)
                     else None)
        self.outdir = outdir
        self.lfw_as_salt_flx = lfw_as_salt_flx
        tm = self.model.time_manager
        # coupler time flags (ocn_init_mct:385-391)
        tm.init_time_flag("cpl_ts", coupling_freq_opt, coupling_freq,
                          owner="ocn_init")
        tm.init_time_flag("cpl_write_restart", restart_freq_opt,
                          restart_freq, owner="ocn_init")
        self.state: Optional[State] = None
        self.forcing = self.model.forcing
        self._sums = None
        self._tlast_coupled = 0.0
        self.restart_files = []

    # -- init phase (ocn_init_mct) -------------------------------------------
    def initialize(self, restart_dir: Optional[str] = None) -> Dict:
        """Set the initial (or restart) state and return the initial export
        state: the reference primes the send buffer with one
        pop_sum_buffer + ocn_export before the first coupling interval
        (ocn_init_mct:424-426)."""
        if restart_dir is not None:
            self.state, nsteps = self._read_restart(restart_dir)
            self.model.nsteps_total = nsteps
            # replay the calendar to the restart step
            self.model.time_manager.reset()
            for _ in range(nsteps):
                self.model.time_manager.advance()
        else:
            self.state = self.model.initial_state()
        self._zero_buffer()
        self._sum_buffer(self.state, avg_ts=False, prime=True)
        return self._export()

    # -- run phase (ocn_run_mct) ---------------------------------------------
    def run(self, x2o: Dict, rstwr: bool = False) -> Dict:
        """Advance the ocean over ONE coupling interval.

        x2o: dict of SI import fields (IMPORT_FIELDS), tensors on the
        model's device: on a rank's block its block of each (a whole field
        is cut to the block).
        rstwr: driver requests a restart write at the end of the interval
        (seq_timemgr_RestartAlarmIsOn -> override_time_flag,
        ocn_comp_mct.F90:608-616).
        Returns the o2x export dict (interval-averaged surface state)."""
        if self.state is None:
            raise RuntimeError("initialize() must be called before run()")
        tm = self.model.time_manager
        if rstwr:
            tm.override_time_flag("cpl_write_restart", True)

        # obtain import state from the driver at the start of the interval
        # (ocn_run_mct:630-646)
        if self.mesh is not None:
            x2o = self.mesh.slab(x2o)
        self.forcing = ocn_import(self.model.step_cfg, self.model.grid, x2o,
                                  lfw_as_salt_flx=self.lfw_as_salt_flx)
        self._zero_buffer()

        while True:
            _, avg_ts = self.model.step_flags(self.model.nsteps_total + 1)
            self.state, _ = self.model.advance(self.state, self.forcing)
            # KE blow-up guard (ocn_run_mct:654-659 -> check_KE)
            self.model.check_ke(self.state)
            self._sum_buffer(self.state, avg_ts)
            if tm.check_time_flag("cpl_ts"):
                o2x = self._export()
                break

        # coupler-requested (or scheduled) restart at the interval end
        if tm.check_time_flag("cpl_write_restart"):
            self.restart_files.append(self._write_restart())
            tm.override_time_flag("cpl_write_restart", None)
        return o2x

    # -- final phase (ocn_final_mct:731-761) ---------------------------------
    def finalize(self) -> Optional[str]:
        """Write the final restart and return its path."""
        if self.state is None:
            return None
        fname = self._write_restart()
        self.restart_files.append(fname)
        return fname

    def _write_restart(self) -> str:
        """The restart of the interval's end: on a rank's block every rank
        writes its block (``io/sharded_restart``, collective)."""
        if self.mesh is not None:
            return sharded_restart.write_sharded_restart(
                self.outdir, self.state, self.model.nsteps_total, self.cfg,
                self.mesh)
        return write_restart(
            f"{self.outdir}/ocn.r.{self.model.nsteps_total:08d}",
            self.state, self.model.nsteps_total, self.cfg,
            pointer_dir=self.outdir)

    def _read_restart(self, restart_dir: str):
        """(state, nsteps) of this rank's block (or the whole domain): a
        sharded restart (its pointer file in ``restart_dir``) written on any
        mesh, else a whole-domain restart, cut to the block."""
        device = self.model.device
        if os.path.exists(os.path.join(restart_dir,
                                       sharded_restart.POINTER_FILE)):
            return sharded_restart.read_sharded_restart(
                restart_dir, self.cfg, mesh=self.mesh, device=device)
        state, nsteps = read_restart(restart_dir, self.cfg, device=device)
        return (self.mesh.slab(state) if self.mesh is not None
                else state), nsteps

    def gather_export(self, o2x: Dict) -> Dict:
        """The whole domain's export from every rank's block of ``o2x``, as
        NumPy on every rank (collective); on the whole domain ``o2x`` as
        NumPy."""
        from pop2_tpu_torch.parallel.multihost import to_host_replicated
        if self.mesh is None:
            return {k: v.detach().cpu().numpy() for k, v in o2x.items()}
        return {k: to_host_replicated(v, self.mesh) for k, v in o2x.items()}

    # -- export buffer (pop_sum_buffer) --------------------------------------
    def _zero_buffer(self):
        cfg = self.model.step_cfg  # the block's rows and columns
        z = torch.zeros((cfg.ny, cfg.nx),
                        dtype=self.cfg.torch_dtype,
                        device=self.model.device)
        self._sums = {k: z for k in
                      ("u", "v", "t", "s", "dhdx", "dhdy")}
        self._tlast_coupled = 0.0

    def _sum_buffer(self, state: State, avg_ts: bool, prime: bool = False):
        """delt-weighted accumulation of the surface export fields
        (pop_sum_buffer: delt = dtt/2 on averaging steps). ``prime`` seeds
        the buffer with the initial state before any step (init phase)."""
        dtt = self.cfg.time.dtt
        delt = (0.5 * dtt) if avg_ts else dtt
        if prime:
            delt = dtt
        s = self._sums
        s["u"] = s["u"] + delt * state.u_cur[0]
        s["v"] = s["v"] + delt * state.v_cur[0]
        s["t"] = s["t"] + delt * state.tracer_cur[0, 0]
        s["s"] = s["s"] + delt * state.tracer_cur[1, 0]
        s["dhdx"] = s["dhdx"] + delt * state.gradpx_cur
        s["dhdy"] = s["dhdy"] + delt * state.gradpy_cur
        self._tlast_coupled += delt

    def _export(self) -> Dict:
        """Normalize the buffer and pack o2x (ocn_export :535-760); the
        ice-formation heat flux comes from the accumulated potential
        (ice_flx_to_coupler, source/ice.F90:625), whose reset lands in the
        state before any restart of the interval is written."""
        norm = 1.0 / max(self._tlast_coupled, 1.0e-20)
        s = self._sums
        bc = self.model.bc
        with pmesh.scope(self.model.mesh):  # a block's shifts: the halos
            u_t = ugrid_to_tgrid(s["u"] * norm, bc)
            v_t = ugrid_to_tgrid(s["v"] * norm, bc)
            dhdx = ugrid_to_tgrid(s["dhdx"] * norm, bc)
            dhdy = ugrid_to_tgrid(s["dhdy"] * norm, bc)
        o2x = {
            "So_t": s["t"] * norm + const.T0_KELVIN,
            "So_s": s["s"] * norm * const.SALT_TO_PPT,
            "So_u": u_t * const.MPERCM,
            "So_v": v_t * const.MPERCM,
            "So_dhdx": dhdx / const.GRAV,
            "So_dhdy": dhdy / const.GRAV,
            "So_ssh": self.state.psurf_cur / const.GRAV * const.MPERCM,
        }
        if self.cfg.liceform:
            qflux, aqice0 = ice_flx_to_coupler(
                self.model.step_cfg, self.model.grid, self.state.tracer_cur,
                self.state.aqice, self._tlast_coupled)
            o2x["Fioo_q"] = qflux / const.HFLUX_FACTOR
            self.state = self.state.replace(aqice=aqice0)
        return o2x
