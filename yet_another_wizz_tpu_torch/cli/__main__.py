"""``python -m yet_another_wizz_tpu_torch.cli``: the pipeline's command line
(:func:`~yet_another_wizz_tpu_torch.cli.commandline.main`)."""

import sys

from yet_another_wizz_tpu_torch.cli.commandline import main

sys.exit(main())
