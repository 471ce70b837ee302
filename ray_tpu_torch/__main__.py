from ray_tpu_torch.scripts.cli import main

raise SystemExit(main())
