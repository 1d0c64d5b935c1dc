"""ray_tpu_torch.util — the port's copies of ``ray_tpu.util`` pieces its
serving path reads: ``chaos`` (the seeded replica fault plan)."""
