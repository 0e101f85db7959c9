"""Cache-policy registry; the import order here is the registry order."""
from repro_torch.core.policies.base import (CachePolicy, get_policy_class,  # noqa: F401
                                            register, registered_policies,
                                            summarize_stats)
from repro_torch.core.policies import nocache  # noqa: F401,E402
from repro_torch.core.policies import fastcache  # noqa: F401,E402
