from setuptools import find_packages, setup

exec(open("extrack_tpu/version.py").read())

setup(
    name="extrack-tpu",
    version=__version__,  # noqa: F821
    description=("TPU-native single-particle-tracking state inference: "
                 "multi-state diffusion model fitting, state annotation, "
                 "duration histograms, position refinement"),
    author="extrack-tpu developers",
    license="GPLv3",
    packages=find_packages(include=["extrack_tpu", "extrack_tpu.*",
                                    "extrack_tpu_torch*"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy", "pandas"],
    extras_require={
        "viz": ["matplotlib"],
        "dev": ["pytest"],
    },
    entry_points={
        "console_scripts": ["extrack-tpu=extrack_tpu.cli:main",
                            "extrack-tpu-gui=extrack_tpu.gui:main",
                            "extrack-tpu-torch=extrack_tpu_torch.cli:main",
                            "extrack-tpu-torch-gui="
                            "extrack_tpu_torch.gui:main"],
    },
)
