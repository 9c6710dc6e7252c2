from .elasticity import (compute_elastic_config, get_compatible_gpus_v01,  # noqa: F401
                         get_compatible_gpus_v02, ElasticityError,
                         ElasticityConfigError, ElasticityIncompatibleWorldSize)
from .elastic_agent import DSElasticAgent  # noqa: F401
