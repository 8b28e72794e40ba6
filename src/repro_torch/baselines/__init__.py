from repro_torch.baselines.policies import (  # noqa: F401
    run_accdecoder, run_biswift, run_neuroscaler, run_reducto, BASELINES,
)
