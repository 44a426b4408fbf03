"""The paper's CL/FL/SL schemes, heterogeneous populations and large
fleets (tiny model), and the scaled CL/FL/SL schemes (dense family)
behind one interface."""
from repro_torch.schemes.base import (BATCH, CFG, LR0, MOMENTUM, N_TEST,
                                      N_TRAIN, ClientReport, RoundReport,
                                      RunResult, SchemeState, corpus, lr_at)
from repro_torch.schemes.centralized import CentralizedScheme
from repro_torch.schemes.faults import FaultPlan
from repro_torch.schemes.federated import FederatedScheme
from repro_torch.schemes.fleet import ClientBatch, FleetScheme
from repro_torch.schemes.population import (ClientSpec, ParticipationPolicy,
                                            PopulationScheme,
                                            aggregate_weighted)
from repro_torch.schemes.radio import Delivery, Radio
from repro_torch.schemes.run import Experiment, build_scheme
from repro_torch.schemes.scaled import (ScaledCentralizedScheme,
                                        ScaledFederatedScheme,
                                        ScaledSplitScheme)
from repro_torch.schemes.split import SplitScheme, evaluate_sl

__all__ = ["BATCH", "CFG", "LR0", "MOMENTUM", "N_TEST", "N_TRAIN",
           "ClientReport", "RoundReport", "RunResult", "SchemeState",
           "corpus", "lr_at", "CentralizedScheme", "FaultPlan",
           "FederatedScheme", "ClientBatch", "FleetScheme", "ClientSpec",
           "ParticipationPolicy", "PopulationScheme", "aggregate_weighted",
           "Delivery", "Radio", "Experiment", "build_scheme", "SplitScheme",
           "evaluate_sl", "ScaledCentralizedScheme", "ScaledFederatedScheme",
           "ScaledSplitScheme"]
