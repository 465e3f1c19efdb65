from .tokens import TokenStream  # noqa: F401
from .vectors import gaussian_mixture, uniform_queries  # noqa: F401
