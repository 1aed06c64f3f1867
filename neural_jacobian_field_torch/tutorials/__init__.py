"""The 2D family's tutorials (the JAX package's examples/tutorial_*.py, the
reference's notebooks/tutorial 1-3), as modules of the port:

  python -m neural_jacobian_field_torch.tutorials.tutorial_1_train_2d_pusher
  python -m neural_jacobian_field_torch.tutorials.tutorial_2_train_2d_finger
  python -m neural_jacobian_field_torch.tutorials.tutorial_2_visualize_2d
  python -m neural_jacobian_field_torch.tutorials.tutorial_3_control_demo

Each runs on the card unless --device names another device (cpu)."""
