from .synthetic import (  # noqa: F401
    RegressionDataset,
    make_classification,
    make_regression,
)
