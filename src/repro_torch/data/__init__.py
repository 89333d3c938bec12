from repro_torch.data.pipeline import (DataConfig, FLDataPipeline,
                                       RegressionSpec, make_regression_data,
                                       make_regression_task, perron_ideal,
                                       regression_loss, synthetic_lm_tokens)

__all__ = ["DataConfig", "FLDataPipeline", "RegressionSpec",
           "make_regression_data", "make_regression_task", "perron_ideal",
           "regression_loss", "synthetic_lm_tokens"]
