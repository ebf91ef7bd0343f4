from repro_torch.optim.adam import Adam, Sgd
from repro_torch.optim.schedules import one_cycle, cosine_decay, constant
