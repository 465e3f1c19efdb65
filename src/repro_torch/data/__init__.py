from .vectors import gaussian_mixture, uniform_queries  # noqa: F401
