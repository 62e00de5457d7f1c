"""core/: the paper's contribution — cost-based scheduling across a hybrid
heterogeneous fleet for energy-efficient LLM inference.

Copies of the reference package's numpy-only modules with only their imports
rewritten, so prices, dispatch decisions and the simulators' results stay
bit-for-bit equal: pricing and scheduling, the static simulator and the
paper's headline (``simulator``), the event and vectorized fleet engines
(``fleet``, ``fleet_vec``), the carbon extension and the region layer."""
from repro_torch.core.systems import (SystemProfile, PROFILES, get_profile,
                                      paper_fleet, tpu_fleet, PowerState,
                                      PowerStateTable, default_power_states)
from repro_torch.core.perf_model import runtime, throughput, query_phases
from repro_torch.core.pricing import (PerfOracle, AnalyticOracle, TableOracle,
                                      CalibratedOracle, Calibration, CostModel,
                                      KernelSample, fit_calibration,
                                      default_cost_model, CostParams, cost,
                                      normalized_cost_params, energy,
                                      energy_per_token_in, energy_per_token_out,
                                      crossover_threshold)
from repro_torch.core.plan import (Plan, PlanTerms, RunPlan, SplitPlan, DeferPlan,
                                   as_plan, plan_to_json, plan_from_json)
from repro_torch.core.settlement import (Booking, reconcile_deltas,
                                         reconcile_split_deltas, resolve_plan,
                                         route_bookings)
from repro_torch.core.workload import (Query, WorkloadSpec, sample_workload,
                                       alpaca_like, token_histogram,
                                       generate_arrivals, poisson_arrivals,
                                       diurnal_arrivals, mmpp_arrivals,
                                       trace_arrivals)
from repro_torch.core.scheduler import (Scheduler, ThresholdScheduler,
                                        CostOptimalScheduler,
                                        CapacityAwareScheduler,
                                        DisaggregatedScheduler,
                                        SingleSystemScheduler,
                                        RoundRobinScheduler, Assignment,
                                        FleetState, PoolSnapshot)
from repro_torch.core.simulator import (simulate, summarize, threshold_sweep,
                                        optimal_threshold, headline, SimResult,
                                        SweepPoint, HeadlineResult)
from repro_torch.core.fleet import (FLEET_ENGINES, FleetSimulator,
                                    FleetSimResult, PoolSpec, RequestRecord,
                                    PoolResult, simulate_fleet,
                                    AutoscalerPolicy,
                                    TargetUtilizationAutoscaler,
                                    QueueDepthAutoscaler)
from repro_torch.core.fleet_vec import VectorizedFleetSimulator
from repro_torch.core.region import (Region, RegionLink, PriceProfile,
                                     flatten_regions, GlobalDispatcher)
