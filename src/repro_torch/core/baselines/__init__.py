from repro_torch.core.baselines.pka import pka_plan
from repro_torch.core.baselines.sieve import sieve_plan
from repro_torch.core.baselines.stem_root import stem_root_plan
