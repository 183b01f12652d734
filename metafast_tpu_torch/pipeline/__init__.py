from .matrix import MatrixResult, matrix_pipeline  # noqa: F401
