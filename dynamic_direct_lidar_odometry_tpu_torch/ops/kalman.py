"""Linear Kalman filter, batched over tracker slots (counterpart of
``ops/kalman.py``): the 10-state constant-velocity box model

    x = [cx, cy, cz, sin(yaw/2), l, w, h, vx, vy, vz],   y = x[:7]

with the JAX package's literals and order of products, in f32.
"""

from __future__ import annotations

from typing import Tuple

import torch

N_STATE = 10
N_MEAS = 7


def transition_matrix(dt: torch.Tensor) -> torch.Tensor:
    """A(dt): x,y,z <- vx,vy,vz (bounding_box_filter.cpp:55-58)."""
    dt = torch.as_tensor(dt, dtype=torch.float32)
    A = torch.eye(N_STATE, dtype=torch.float32, device=dt.device)
    A[0, 7] = dt
    A[1, 8] = dt
    A[2, 9] = dt
    return A


def measurement_matrix(device=None) -> torch.Tensor:
    return torch.eye(N_MEAS, N_STATE, dtype=torch.float32, device=device)


def initial_covariance(device=None) -> torch.Tensor:
    """P0 = diag(1000 x7, 10000 x3) (bounding_box_filter.cpp:28-30)."""
    return torch.diag(
        torch.tensor([1000.0] * 7 + [10000.0] * 3, dtype=torch.float32, device=device)
    )


def process_noise(device=None) -> torch.Tensor:
    """Q = diag(1 x7, 0.01 x3) (bounding_box_filter.cpp:35-37)."""
    return torch.diag(
        torch.tensor([1.0] * 7 + [0.01] * 3, dtype=torch.float32, device=device)
    )


def measurement_noise(device=None) -> torch.Tensor:
    """R = I7 (bounding_box_filter.cpp:32-33)."""
    return torch.eye(N_MEAS, dtype=torch.float32, device=device)


def predict(
    x: torch.Tensor, P: torch.Tensor, dt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched predict: x = A x, P = A P A^T + Q (kalman.cpp:69-81).
    x (T, 10), P (T, 10, 10), dt scalar."""
    A = transition_matrix(torch.as_tensor(dt, device=x.device))
    Q = process_noise(x.device)
    x_new = x @ A.T
    P_new = A @ P @ A.T + Q
    return x_new, P_new


def update(
    x: torch.Tensor, P: torch.Tensor, y: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched measurement update (kalman.cpp:83-92):
    K = P C^T (C P C^T + R)^-1; x += K (y - C x); P = (I - K C) P.
    x (T, 10), P (T, 10, 10), y (T, 7)."""
    C = measurement_matrix(x.device)
    R = measurement_noise(x.device)
    S = C @ P @ C.T + R  # (T, 7, 7)
    PCt = P @ C.T  # (T, 10, 7)
    # solve_ex: no singularity check, which would read the status back
    # to the host (S = C P C^T + I is positive definite)
    K = torch.linalg.solve_ex(S, PCt.transpose(-1, -2))[0].transpose(-1, -2)
    innov = y - x[:, :N_MEAS]
    x_new = x + (K @ innov[:, :, None])[:, :, 0]
    KC = K @ C
    eye = torch.eye(N_STATE, dtype=torch.float32, device=x.device)
    P_new = (eye - KC) @ P
    return x_new, P_new
