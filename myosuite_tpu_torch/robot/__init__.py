from myosuite_tpu_torch.robot.robot import (HardwareDriver, Robot,
                                            SensorCache, sensor2sim)
