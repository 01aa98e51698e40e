"""MCAL campaign loop, tasks and device engines (``repro.core``)."""
from repro_torch.core.baselines import (ALResult, oracle_al,  # noqa: F401
                                        run_naive_al)
from repro_torch.core.cost import (AMAZON, SATYAM, SERVICES, CostLedger,  # noqa: F401
                                   LabelQuality, LabelingService,
                                   TrainCostModel)
from repro_torch.core.emulator import (DATASETS, EmulatedTask,  # noqa: F401
                                       make_emulated_task)
from repro_torch.core.mcal import (MCALCampaign, MCALConfig, MCALResult,  # noqa: F401
                                   SharedPool, run_mcal, select_architecture)
from repro_torch.core.scoring import PoolScoringEngine, ScoringConfig  # noqa: F401
from repro_torch.core.selection_device import (KCenterConfig,  # noqa: F401
                                               k_center_greedy_device)
from repro_torch.core.task import LiveTask  # noqa: F401
from repro_torch.core import selection  # noqa: F401
