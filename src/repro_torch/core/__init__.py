# The paper's system in PyTorch: the forecasting models, the Forecaster
# facade and the task / experiment assembly path, re-exported as the
# reference's ``repro.core`` does.
from repro_torch.core.forecaster import (
    Forecaster,
    forecaster_names,
    get_forecaster,
    load_forecaster,
    register_forecaster,
    save_forecaster,
)
from repro_torch.core.tasks import (
    ExperimentSpec,
    ForecastTask,
    get_task,
    register_task,
    run_experiment,
    task_forecaster,
    task_names,
)
