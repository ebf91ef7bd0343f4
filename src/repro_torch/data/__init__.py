from repro_torch.data.synthetic import (
    ev_synthetic,
    nn5_synthetic,
    household_synthetic,
    ett_like,
    weather_like,
)
from repro_torch.data.windowing import (
    make_windows,
    split_windows,
    split_series,
    client_datasets,
    client_series,
    client_series_datasets,
    series_norm_stats,
    window_split_counts,
)
from repro_torch.data.clustering import dtw_distance_matrix, kmedoids
