"""YAML control-file schema (pydantic).

Shape-compatible with the reference's ``troute-config`` pydantic schema
(``troute-config/troute/config/config.py`` and friends) so existing T-Route
control files validate and drive this framework: the same four top-level
blocks (log / network topology / compute / output), the same key names for
the knobs this framework consumes, and permissive pass-through for the
rest.  Cross-field rules implemented here mirror the reference root
validators (waterbody file required when breaking at waterbodies, diffusive
domain required for hybrid routing).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import yaml
from pydantic import BaseModel, ConfigDict, Field, model_validator


class _Permissive(BaseModel):
    model_config = ConfigDict(extra="allow")


class LogParameters(_Permissive):
    showtiming: Optional[bool] = False
    log_level: Optional[str] = "DEBUG"
    log_directory: Optional[str] = None


class ColumnMapping(_Permissive):
    key: str = "link"
    downstream: str = "to"
    dx: str = "Length"
    n: str = "n"
    ncc: str = "nCC"
    s0: str = "So"
    bw: str = "BtmWdth"
    tw: str = "TopWdth"
    twcc: str = "TopWdthCC"
    cs: str = "ChSlp"
    waterbody: str = "NHDWaterbodyComID"
    gages: str = "gages"
    alt: str = "alt"
    musk: str = "MusK"
    musx: str = "MusX"


class SupernetworkParameters(_Permissive):
    geo_file_path: Optional[str] = None
    mask_file_path: Optional[str] = None
    network_type: str = "HYFeaturesNetwork"
    columns: Optional[ColumnMapping] = None
    terminal_code: int = 0
    synthetic_wb_segments: Optional[List[int]] = None
    synthetic_wb_id_offset: float = 9.99e11


class LevelPoolParams(_Permissive):
    level_pool_waterbody_parameter_file_path: Optional[str] = None
    level_pool_waterbody_id: str = "lake_id"


class WaterbodyParameters(_Permissive):
    break_network_at_waterbodies: bool = False
    level_pool: Optional[LevelPoolParams] = None
    waterbody_null_code: int = -9999


class PreprocessingParameters(_Permissive):
    preprocess_only: bool = False
    preprocess_output_folder: Optional[str] = None
    preprocess_output_filename: str = "preprocess_output"
    use_preprocessed_data: bool = False
    preprocess_source_file: Optional[str] = None


class NetworkTopologyParameters(_Permissive):
    preprocessing_parameters: PreprocessingParameters = Field(
        default_factory=PreprocessingParameters)
    supernetwork_parameters: SupernetworkParameters
    waterbody_parameters: WaterbodyParameters = Field(
        default_factory=WaterbodyParameters)

    @model_validator(mode="after")
    def _check_waterbody_file(self):
        # NHD networks need LAKEPARM; HYFeatures carries lake params in the
        # geopackage (reference config.py check_levelpool_filepath)
        wb = self.waterbody_parameters
        if (wb.break_network_at_waterbodies
                and self.supernetwork_parameters.network_type == "NHDNetwork"):
            if not (wb.level_pool
                    and wb.level_pool.level_pool_waterbody_parameter_file_path):
                raise ValueError(
                    "break_network_at_waterbodies requires "
                    "level_pool_waterbody_parameter_file_path for NHDNetwork")
        return self


class RestartParameters(_Permissive):
    start_datetime: Optional[str] = None
    lite_channel_restart_file: Optional[str] = None
    lite_waterbody_restart_file: Optional[str] = None
    wrf_hydro_channel_restart_file: Optional[str] = None
    wrf_hydro_waterbody_restart_file: Optional[str] = None
    wrf_hydro_channel_ID_crosswalk_file: Optional[str] = None
    wrf_hydro_waterbody_ID_crosswalk_file: Optional[str] = None
    wrf_hydro_waterbody_crosswalk_filter_file: Optional[str] = None


class HybridParameters(_Permissive):
    run_hybrid_routing: bool = False
    diffusive_domain: Optional[str] = None
    use_natl_xsections: bool = False
    topobathy_domain: Optional[str] = None
    run_refactored_network: bool = False
    refactored_domain: Optional[str] = None
    refactored_topobathy_domain: Optional[str] = None
    coastal_boundary_domain: Optional[str] = None
    # "float64" = reference precision; "float32" = the accelerator's
    # working precision.  "auto" (default) resolves per backend at run
    # time: float32 on an accelerator, float64 on the CPU (see
    # ``resolved_diffusive``).
    diffusive_dtype: str = "auto"
    # "jacobi" (default) = depth-independent fixed-point corrector — after
    # at most depth-D sweeps it reproduces the sequential substitution
    # exactly (triangular chain), and with warm starts converges in a
    # handful, ~5x faster on long mainstems; "wavefront" = the
    # reference-shaped sequential node sweep
    diffusive_corrector: str = "jacobi"
    # "auto" (default) routes each independent tailwater tree as its own
    # lane of a batched [B, R, C] run with a per-domain adaptive dt —
    # matching the reference, which calls diffnw once per tailwater
    # domain so each gets an independent calculateDT; "never" keeps the
    # merged single-[R, C] form (all tailwaters coupled to the global
    # most-restrictive dt).  Single-tailwater domains are unaffected.
    diffusive_batching: str = "auto"
    # When an int (e.g. 128), resample the hot lookup-table columns onto
    # per-node sqrt-stretched elevation grids of this many entries — the
    # jacobi corrector's table fetches become index arithmetic + short
    # one-hot passes instead of searches over the 501-entry non-uniform
    # grid, and the sweep switches to Gauss-Seidel-within-reach.  Accuracy
    # studies of the JAX package: tests/test_diffusive_uniform.py
    # (synthetic: at 128, steady flows within ~2%, surfaces within ~1 cm;
    # steep transients can show larger instantaneous dq from hydrograph
    # phase shift, volumes agree) and tests/test_hurricane_laura.py (real
    # Gulf-coast bathymetry, same quantile assertions).  None/0 = exact
    # reference-parity lookups.  "auto" (default) resolves per backend: 128
    # on an accelerator, exact on the CPU.
    diffusive_table_nel: Optional[Union[int, str]] = "auto"

    def resolved_diffusive(self, backend: str) -> tuple:
        """Resolve the backend-aware ``"auto"`` defaults to concrete
        ``(dtype_str, nel_uniform)`` values for ``backend``, the type of
        the routing device ("cpu" or "cuda").

        On an accelerator "auto" is float32 with uniform 128-entry tables;
        on the CPU, and whenever the user pins explicit values (e.g. for
        reference parity), the exact-table float64 configuration runs.
        Only hybrid routing reads these, so callers need not resolve them
        while it is off.

        The JAX package chose this for a TPU, which emulates float64.  An
        H100 computes float64 natively, and the choice stands there too:
        on the diffusive benchmark tree (2,048 reaches of 16 nodes, 24
        steps; NVIDIA H100 80GB HBM3, 700 W, ``chip_smoke.py`` phase 10)
        float32 with uniform tables was the fastest configuration,
        17.81-33.14 s per run, and float64 with exact tables took 37.25-
        50.43 s, 1.5-2.2x as long (PERF.md).
        """
        accel = backend != "cpu"
        dtype = self.diffusive_dtype
        if dtype == "auto":
            dtype = "float32" if accel else "float64"
        nel = self.diffusive_table_nel
        if isinstance(nel, str):
            nel = 128 if accel else None
        return dtype, (nel or None)

    @model_validator(mode="after")
    def _check_domain(self):
        if self.run_hybrid_routing and not self.diffusive_domain:
            raise ValueError("run_hybrid_routing requires diffusive_domain")
        if self.use_natl_xsections and not self.topobathy_domain:
            raise ValueError("use_natl_xsections requires topobathy_domain")
        return self


class ForcingParameters(_Permissive):
    qts_subdivisions: int = 12
    dt: float = 300.0
    nts: Optional[int] = None
    max_loop_size: float = 24.0
    qlat_input_folder: Optional[str] = None
    # single-CSV / constant fallbacks when no folder is given
    # (reference NHDNetwork.build_qlateral_array, NHDNetwork.py:388-397)
    qlat_input_file: Optional[str] = None
    qlat_file_pattern_filter: Optional[str] = "*CHRTOUT_DOMAIN1"
    qlat_file_index_col: str = "feature_id"
    qlat_file_value_col: str = "q_lateral"
    qlat_const: float = 0.0
    qlat_file_gw_bucket_flux_col: str = "qBucket"
    qlat_file_terrain_runoff_col: str = "qSfcLatRunoff"
    nexus_input_folder: Optional[str] = None
    coastal_boundary_input_file: Optional[str] = None
    # overlap run-set forcing reads with routing (the capability the
    # reference's main_v03_async pipelined via asyncio executors,
    # __main__.py:1995-2115; its dispatch is commented out there).  The
    # main_v03_async entry point here forces this on.
    async_prefetch: bool = False
    # pre-enumerated run sets [{qlat_files: [...], nts: N}, ...]
    # (reference AbstractNetwork.build_forcing_sets, :747)
    qlat_forcing_sets: Optional[List[Dict[str, Any]]] = None


class StreamflowDAParameters(_Permissive):
    streamflow_nudging: bool = False
    diffusive_streamflow_nudging: bool = False
    gage_segID_crosswalk_file: Optional[str] = None
    crosswalk_gage_field: Optional[str] = "gages"
    crosswalk_segID_field: Optional[str] = "link"
    lastobs_output_folder: Optional[str] = None
    lastobs_file: Optional[str] = None


class ReservoirPersistenceDA(_Permissive):
    reservoir_persistence_usgs: bool = False
    reservoir_persistence_usace: bool = False
    reservoir_persistence_greatLake: bool = False
    crosswalk_usgs_gage_field: str = "usgs_gage_id"
    crosswalk_usace_gage_field: str = "usace_gage_id"


class ReservoirRfcDA(_Permissive):
    reservoir_rfc_forecasts: bool = False
    reservoir_rfc_forecasts_time_series_path: Optional[str] = None
    reservoir_rfc_forecasts_lookback_hours: int = 28
    reservoir_rfc_forecasts_offset_hours: int = 28
    reservoir_rfc_forecast_persist_days: int = 11


class ReservoirDAParameters(_Permissive):
    reservoir_persistence_da: Optional[ReservoirPersistenceDA] = None
    reservoir_rfc_da: Optional[ReservoirRfcDA] = None
    reservoir_parameter_file: Optional[str] = None


class DataAssimilationParameters(_Permissive):
    usgs_timeslices_folder: Optional[str] = None
    usace_timeslices_folder: Optional[str] = None
    canada_timeslices_folder: Optional[str] = None
    LakeOntario_outflow: Optional[str] = None
    timeslice_lookback_hours: Optional[int] = 24
    interpolation_limit_min: Optional[int] = 59
    qc_threshold: Optional[float] = 1.0
    # nudging decay time constant in minutes (reference
    # DataAssimilation.py:85 default 120)
    da_decay_coefficient: float = 120.0
    streamflow_da: Optional[StreamflowDAParameters] = None
    reservoir_da: Optional[ReservoirDAParameters] = None


class ComputeParameters(_Permissive):
    parallel_compute_method: str = "by-subnetwork-jit-clustered"
    compute_kernel: str = "V02-structured"
    assume_short_ts: bool = False
    subnetwork_target_size: int = 10000
    cpu_pool: Optional[int] = None
    return_courant: bool = False
    # extension: strict-mode fixed-point iteration instead of the
    # sequential level scan (depth-independent; engine.RoutingConfig)
    strict_iterative: bool = False
    restart_parameters: RestartParameters = Field(
        default_factory=RestartParameters)
    hybrid_parameters: HybridParameters = Field(
        default_factory=HybridParameters)
    forcing_parameters: ForcingParameters = Field(
        default_factory=ForcingParameters)
    data_assimilation_parameters: DataAssimilationParameters = Field(
        default_factory=DataAssimilationParameters)


class ChrtoutOutputParameters(_Permissive):
    wrf_hydro_channel_output_source_folder: Optional[str] = None


class ChanobsOutputParameters(_Permissive):
    chanobs_output_directory: Optional[str] = None
    chanobs_filepath: Optional[str] = None


class StreamOutput(_Permissive):
    stream_output_directory: Optional[str] = None
    stream_output_time: float = 1.0
    stream_output_type: str = ".nc"
    stream_output_internal_frequency: int = 60
    mask_output: Optional[str] = None


class OutputParameters(_Permissive):
    csv_output: Optional[Dict[str, Any]] = None
    parquet_output: Optional[Dict[str, Any]] = None
    chrtout_output: Optional[ChrtoutOutputParameters] = None
    chanobs_output: Optional[ChanobsOutputParameters] = None
    lite_restart: Optional[Dict[str, Any]] = None
    lakeout_output: Optional[str] = None
    # alias of streamflow_da.lastobs_output_folder (reference output.py:192)
    lastobs_output: Optional[str] = None
    stream_output: Optional[StreamOutput] = None
    test_output: Optional[str] = None
    wrf_hydro_parity_check: Optional[Dict[str, Any]] = None
    # appends qlink1/qlink2/hlink_troute into existing HYDRO_RST files
    # (reference output.py:358-399)
    wrf_hydro_restart_output: Optional[Dict[str, Any]] = None


class BMIParameters(_Permissive):
    flowpath_columns: Optional[List[str]] = None
    attributes_columns: Optional[List[str]] = None
    waterbody_columns: Optional[List[str]] = None
    network_columns: Optional[List[str]] = None


class Config(_Permissive):
    log_parameters: LogParameters = Field(default_factory=LogParameters)
    network_topology_parameters: Optional[NetworkTopologyParameters] = None
    compute_parameters: ComputeParameters = Field(
        default_factory=ComputeParameters)
    output_parameters: OutputParameters = Field(
        default_factory=OutputParameters)
    bmi_parameters: Optional[BMIParameters] = None

    @classmethod
    def with_strict_mode(cls, data: dict, base: Path) -> "Config":
        """Validate and additionally check that referenced paths exist."""
        cfg = cls.model_validate(data)
        missing = []
        for p in cfg.referenced_paths():
            if p and not (base / p).exists():
                missing.append(str(p))
        if missing:
            raise FileNotFoundError(f"missing input paths: {missing}")
        return cfg

    def referenced_paths(self) -> List[str]:
        out = []
        if self.network_topology_parameters:
            sp = self.network_topology_parameters.supernetwork_parameters
            out.append(sp.geo_file_path)
            wb = self.network_topology_parameters.waterbody_parameters
            if wb.level_pool:
                out.append(wb.level_pool.level_pool_waterbody_parameter_file_path)
        fp = self.compute_parameters.forcing_parameters
        out.append(fp.qlat_input_folder)
        out.append(fp.qlat_input_file)
        return [p for p in out if p]


def normalize_v3_keys(data: dict, strict_v3: bool = False,
                      mapped: list | None = None) -> dict:
    """Map v3-era control-file keys onto their v4 shapes, in place.

    The reference's v3 entry point consumes these keys directly
    (``nwm_routing/input.py:427-560`` validates them; ``main_v03`` and the
    DA builders read them), while ``main_v04`` reads the nested v4 shapes.
    Only absent v4 keys are filled, so v4 configs pass through untouched:

    - ``supernetwork_parameters.geo_file_type`` -> ``network_type``
    - ``streamflow_da.wrf_hydro_lastobs_file`` -> ``lastobs_file``
      (reference ``input.py:471-475`` setdefault)
    - ``data_assimilation_parameters.lastobs_output_folder`` ->
      ``streamflow_da.lastobs_output_folder``
    - flat ``reservoir_da.reservoir_persistence_usgs/usace`` ->
      ``reservoir_da.reservoir_persistence_da.*`` (carrying any flat
      ``crosswalk_*`` field-name overrides, which the reference reads
      from the flat block; ``preprocess.py:315-318``)
    - ``reservoir_da.gage_lakeID_crosswalk_file`` ->
      ``reservoir_da.reservoir_parameter_file`` (the v4 name for the same
      reservoir_index file; reference ``DataAssimilation.py:1277``)
    - ``waterbody_parameters.rfc`` block ->
      ``reservoir_da.reservoir_rfc_da``; this applies even when the
      ``reservoir_da:`` mapping is explicitly null (children commented
      out) — the reference engages RFC DA independently of reservoir_da
      presence (``preprocess.py:293-303``).

    ``reservoir_parameter_file`` precedence: with ``strict_v3`` the rfc
    block wins whenever it exists, even clobbering the crosswalk-derived
    value with None — exactly the reference's v3 path
    (``preprocess.py:294-299`` overwrites ``param_file`` with
    ``rfc_params.get('reservoir_parameter_file', None)``).  Without
    ``strict_v3`` (mixed/auto loading) the rfc value only wins when the
    key is actually present in the rfc block, so a v4 config's explicit
    reservoir_da settings survive a stale commented-down rfc block.

    ``mapped`` (optional list) collects a description of every key this
    call actually rewrote, so callers can surface mixed v3/v4 configs.
    """
    if not isinstance(data, dict):
        return data
    if mapped is None:
        mapped = []

    def sub(d, k):
        v = d.get(k) if isinstance(d, dict) else None
        return v if isinstance(v, dict) else None

    sp = sub(sub(data, "network_topology_parameters"),
             "supernetwork_parameters")
    if sp and sp.get("geo_file_type") and "network_type" not in sp:
        sp["network_type"] = str(sp["geo_file_type"])
        mapped.append("geo_file_type -> network_type")

    cp = sub(data, "compute_parameters")
    dap = sub(cp, "data_assimilation_parameters")
    if dap is None:
        return data
    sda = sub(dap, "streamflow_da")
    if sda is not None:
        if sda.get("wrf_hydro_lastobs_file") and "lastobs_file" not in sda:
            sda["lastobs_file"] = sda["wrf_hydro_lastobs_file"]
            mapped.append("wrf_hydro_lastobs_file -> lastobs_file")
        if dap.get("lastobs_output_folder") \
                and "lastobs_output_folder" not in sda:
            sda["lastobs_output_folder"] = dap["lastobs_output_folder"]
            mapped.append("lastobs_output_folder -> streamflow_da")

    rfc_wb = sub(sub(sub(data, "network_topology_parameters"),
                     "waterbody_parameters"), "rfc")
    rda = sub(dap, "reservoir_da")
    # also replaces an explicitly-null ``reservoir_da:`` mapping — the
    # common all-children-commented-out YAML idiom — so the rfc block
    # still engages (reference preprocess.py:293-303)
    if rda is None and rfc_wb is not None:
        rda = dap["reservoir_da"] = {}
    if rda is not None:
        flat = ("reservoir_persistence_usgs" in rda
                or "reservoir_persistence_usace" in rda)
        if flat and "reservoir_persistence_da" not in rda:
            pda = {
                "reservoir_persistence_usgs":
                    rda.get("reservoir_persistence_usgs", False),
                "reservoir_persistence_usace":
                    rda.get("reservoir_persistence_usace", False),
            }
            # flat crosswalk field-name overrides ride along (the
            # reference reads them off the flat v3 block,
            # preprocess.py:315-318)
            pda.update({k: v for k, v in rda.items()
                        if k.startswith("crosswalk_")})
            rda["reservoir_persistence_da"] = pda
            mapped.append("flat reservoir_da -> reservoir_persistence_da")
        if rda.get("gage_lakeID_crosswalk_file") \
                and "reservoir_parameter_file" not in rda:
            rda["reservoir_parameter_file"] = \
                rda["gage_lakeID_crosswalk_file"]
            mapped.append(
                "gage_lakeID_crosswalk_file -> reservoir_parameter_file")
        if rfc_wb is not None:
            if "reservoir_rfc_forecasts" in rfc_wb \
                    and "reservoir_rfc_da" not in rda:
                rda["reservoir_rfc_da"] = {
                    k: rfc_wb[k] for k in (
                        "reservoir_rfc_forecasts",
                        "reservoir_rfc_forecasts_time_series_path",
                        "reservoir_rfc_forecasts_lookback_hours",
                        "reservoir_rfc_forecasts_offset_hours",
                        "reservoir_rfc_forecast_persist_days",
                    ) if k in rfc_wb}
                mapped.append("waterbody_parameters.rfc -> reservoir_rfc_da")
            # rfc-block precedence — see the docstring
            if strict_v3:
                if rda.get("reservoir_parameter_file") != \
                        rfc_wb.get("reservoir_parameter_file"):
                    mapped.append("rfc.reservoir_parameter_file override")
                rda["reservoir_parameter_file"] = \
                    rfc_wb.get("reservoir_parameter_file")
            elif "reservoir_parameter_file" in rfc_wb:
                if rda.get("reservoir_parameter_file") not in (
                        None, rfc_wb["reservoir_parameter_file"]):
                    mapped.append("rfc.reservoir_parameter_file override")
                rda["reservoir_parameter_file"] = \
                    rfc_wb["reservoir_parameter_file"]
    return data


def load_config(path, strict: bool = False,
                v3: bool | None = None) -> Config:
    """Load and validate a YAML control file (reference CLI entry parity).

    ``v3`` gates v3-era key normalization: True = normalize with the
    reference's exact v3 precedence; False = v4-only (v3 keys ignored,
    like the reference's ``main_v04``); None (default) = normalize
    permissively and log a warning when any v3 keys were actually mapped,
    so mixed configs are visible.
    """
    path = Path(path)
    with open(path) as f:
        data = yaml.safe_load(f)
    if v3 is not False:
        mapped: list = []
        data = normalize_v3_keys(data, strict_v3=bool(v3), mapped=mapped)
        if v3 is None and mapped:
            import logging
            logging.getLogger(__name__).warning(
                "config %s carries v3-era keys, normalized to v4 shapes: "
                "%s (pass -V3 / v3=True to silence)", path,
                "; ".join(mapped))
    if strict:
        return Config.with_strict_mode(data, path.parent)
    return Config.model_validate(data)
