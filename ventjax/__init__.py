"""ventjax: hyperpolarized 129Xe ventilation-MRI analysis in JAX."""
from ventjax.config import VentConfig, DEFAULT_CONFIG, VERSION as __version__
