"""Demo drivers of the port (counterparts of the repository's ``demo/``).

Each module runs one scene through ``SimulationRunner.run`` on the card
(``--device cpu`` for the plain PyTorch versions), writes a PNG frame every
``--io_interval`` steps into ``--out_dir`` (default: ``demo_data_<name>/``
beside the drivers) and, where ``imageio`` imports, an mp4::

    python -m lbm_ferrofluid_tpu_torch.demo.demo_3d_LBM_Rosensweig_instability \\
        --total_steps 8000 --io_interval 10

Each module's ``main(argv)`` takes the command line as a list and returns
the final state.
"""
