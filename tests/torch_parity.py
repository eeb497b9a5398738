"""Shared inputs for the ``test_torch_*`` parity tests: seeded numpy
states and parameters that feed the JAX package and its PyTorch port
alike (the two frameworks' generators differ, so inputs come from
numpy). Cube states near the ground come from the port's
``assets.cube_states_near_ground``, which ``chip_smoke.py`` uses too."""
import numpy as np

DT = 0.0068


def perturbed_params(rng: np.random.Generator, theta, friction, geometry):
    """Perturbs JAX ``MultibodyParams`` fields given as numpy arrays;
    returns ``(theta, friction, geometry)`` in the same form."""
    theta = np.asarray(theta) + 0.1 * rng.standard_normal(np.shape(theta))
    friction = np.asarray(friction) * rng.uniform(0.8, 1.25,
                                                  np.shape(friction))
    geometry = [None if g is None else
                {key: np.asarray(val) * rng.uniform(0.95, 1.05,
                                                    np.shape(val))
                 for key, val in g.items()}
                for g in geometry]
    return theta, friction, geometry


def params_numpy(params):
    """JAX ``MultibodyParams`` -> ``(theta, friction, geometry)`` numpy."""
    return (np.asarray(params.theta), np.asarray(params.friction),
            [None if g is None else {k: np.asarray(v) for k, v in g.items()}
             for g in params.geometry])
