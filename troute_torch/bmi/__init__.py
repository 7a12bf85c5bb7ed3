"""BMI 2.0 components of the port: routing (``BmiTroute``), one reservoir
(``bmi_reservoirs.BmiReservoir``) and DA forcing
(``bmi_daforcing.BmiDAforcing``)."""
from troute_torch.bmi.bmi_troute import BmiTroute
