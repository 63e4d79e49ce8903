from .sampler import (
    PREDICTION_SCHEMA_FIELDS, DDIMSampler, load_predictions_parquet, save_predictions_parquet,
)

__all__ = ["DDIMSampler", "PREDICTION_SCHEMA_FIELDS", "load_predictions_parquet",
           "save_predictions_parquet"]
