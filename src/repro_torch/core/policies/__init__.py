"""Cache-policy registry; the import order here is the registry order, the
reference's ``repro.core.POLICIES`` order."""
from repro_torch.core.policies.base import (CachePolicy, get_policy_class,  # noqa: F401
                                            register, registered_policies,
                                            summarize_stats)
from repro_torch.core.policies import nocache  # noqa: F401,E402
from repro_torch.core.policies import fora  # noqa: F401,E402
from repro_torch.core.policies import teacache  # noqa: F401,E402
from repro_torch.core.policies import adacache  # noqa: F401,E402
from repro_torch.core.policies import fbcache  # noqa: F401,E402
from repro_torch.core.policies import l2c  # noqa: F401,E402
from repro_torch.core.policies import fastcache  # noqa: F401,E402
from repro_torch.core.policies import smoothcache  # noqa: F401,E402
